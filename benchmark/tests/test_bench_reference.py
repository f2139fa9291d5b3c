"""The plain reference and the benchmark's frozen copies held to the
port's CPU path on the same seeded inputs."""

import filecmp

import numpy as np
import pytest
import torch

from benchmark.harness import compare, dataset, manifest
from benchmark.reference import batches, rnn_cce
from benchmark.tests import tiny


def test_dataset_files_are_the_ports_synthetic_layout(tmp_path):
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.data.synthetic import catalog_interactions, write_dataset

    rows = catalog_interactions(n_users=300, n_items=3000, min_len=5, max_len=60, seed=4)
    ours = dataset.catalog_interactions(300, 3000, 5, 60, 0.45, 0.5, np.random.default_rng(4))
    assert np.array_equal(rows, ours)
    write_dataset(str(tmp_path / "port"), rows.copy(), n_val_users=20, n_test_users=20, seed=6)
    data = dataset.write_dataset(str(tmp_path / "bench"), rows.copy(), 20, 20, 2, 5, np.random.default_rng(6))
    for f in ("train_set_sequences", "val_set_sequences", "test_set_sequences", "train_set_triplets", "stats"):
        assert filecmp.cmp(tmp_path / "port" / "data" / f, tmp_path / "bench" / "data" / f, shallow=False), f
    handler = DataHandler(str(tmp_path / "port") + "/")
    assert np.array_equal(handler.training_set.store.items, data.train_items)
    assert np.array_equal(handler.training_set.store.offsets, data.train_offsets)
    assert handler.n_items == data.n_items
    assert np.array_equal(np.load(tmp_path / "bench" / "data" / "training_set_item_popularity.npy"),
                          handler.item_popularity)


@pytest.mark.parametrize("K", [1, 3])
def test_batches_are_the_index_wires(tmp_path, K):
    """The frozen sampler and expansion give the port's batches step for
    step (``_gen_index_mini_batch`` then ``_expand_index_wire``)."""
    bench = tiny.TinyManifest(batch=24, max_length=9)
    config = bench.config("gru50_cce_17770")
    traffic = dict(bench.traffic("l200_b4096"), steps_per_dispatch=K)
    data = dataset.generate(str(tmp_path / "ds"), traffic, 300, 77)
    from benchmark.programs import rnn_cce as program

    predictor, handler = program.build(config, traffic, data.dirname, 12345, "cpu")
    predictor.set_dataset(handler)
    store = predictor._upload_index_store(handler.training_set)
    wire = predictor._gen_index_mini_batch(handler.training_set, np.random.default_rng(12345 + 77), n_stack=K)
    ours = batches.steps(data.train_items, data.train_offsets, 12345, 24, K, 9)
    for _ in range(4):
        payload = next(wire)
        for k in range(K):
            step = {key: torch.from_numpy(np.asarray(v[k])) for key, v in payload.items()}
            port = predictor._expand_index_wire(step, store)
            ids, lengths, targets = next(ours)
            assert np.array_equal(port["ids"][..., 0].numpy(), ids)
            assert np.array_equal(port["mask"].numpy(), (np.arange(9)[None, :] < lengths[:, None]).astype(np.float32))
            assert np.array_equal(port["targets"].numpy(), targets)


@pytest.mark.parametrize("cell", list(manifest.Manifest().workloads))
@pytest.mark.parametrize("db", [0.0, 0.5])
def test_reference_follows_the_ports_cpu_path(cell, db):
    """Three Adam steps of the port's CPU path (its plain versions of the
    kernels) and of the reference from the same weights on the same
    batches, with and without diversity-bias weights."""
    bench = tiny.TinyManifest(flags=["--db", str(db)])
    if db:
        real = bench.config

        def config(name):
            c = real(name)
            c["model"]["diversity_bias"] = db
            return c

        bench.config = config
    out = tiny.run(cell, bench=bench)
    values = compare.numbers(out["readings"]["port"], out["readings"]["reference"])
    assert values["cost_rel_gap"] < 1e-6 and values["grad_norm_gap"] < 1e-5 and values["change_norm_gap"] < 1e-5
    assert out["correct"], out["checks"]


def test_reference_scan_is_the_ports_plain_scan():
    """The reference's masked GRU and LSTM and their clipped gradients
    against the port's plain training scans (``*_scan_train_plain``)."""
    from seqrec_tpu_torch.ops.lstm_scan_train import lstm_scan_train_plain
    from seqrec_tpu_torch.ops.rnn_scan_train import gru_scan_train_plain

    g = torch.Generator().manual_seed(3)
    for cell in ("GRU", "LSTM"):
        model = {"cell": cell, "hidden": 8}
        p = rnn_cce.make_weights(model, 20, 5, "cpu")
        p = {k: (v + 0.3 * torch.randn(v.shape, generator=g)).requires_grad_(True) for k, v in p.items()}
        ids = torch.randint(0, 20, (6, 7), generator=g)
        lengths = torch.tensor([7, 1, 3, 5, 2, 6])
        clip = 0.05  # binds
        h = rnn_cce.final_state(p, cell, ids, lengths, clip)
        x = p["W_in"][ids] + p["b"]
        mask = (torch.arange(7)[None, :] < lengths[:, None]).float()
        x_port = x.detach().requires_grad_(True)
        if cell == "GRU":
            h_port = gru_scan_train_plain(x_port, mask, p["W_hid"], p["h0"].expand(6, 8), clip)
        else:
            peep = torch.stack([p["w_ci"], p["w_cf"], p["w_co"]])
            h_port = lstm_scan_train_plain(x_port, mask, p["W_hid"], peep, p["h0"].expand(6, 8),
                                           p["c0"].expand(6, 8), clip)
        assert torch.allclose(h, h_port, atol=1e-6)
        up = torch.randn(6, 8, generator=g)
        (gw,) = torch.autograd.grad((h * up).sum(), [p["W_hid"]])
        (gw_port,) = torch.autograd.grad((h_port * up).sum(), [p["W_hid"]])
        assert torch.allclose(gw, gw_port, atol=1e-6)


def test_make_weights_is_a_function_of_the_seed():
    model = {"cell": "LSTM", "hidden": 8}
    a, b = rnn_cce.make_weights(model, 50, 2**31 + 9, "cpu"), rnn_cce.make_weights(model, 50, 2**31 + 9, "cpu")
    c = rnn_cce.make_weights(model, 50, 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W_in"], c["W_in"])
    assert set(a) == set(rnn_cce.leaf_shapes(model, 50))
    assert float(a["W_out"].abs().max()) <= float(np.sqrt(6 / 58))
