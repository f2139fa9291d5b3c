"""Checkpoints of the port against the JAX package on the CPU: optimizer
state (``save_optimizer_state``) written by either package resumes in the
other, a JAX-written bf16-moment checkpoint loads without ``ml_dtypes``,
the async save queue writes what synchronous saves write, ``--save_rank``
writes the JAX CLI's ``_full_rank`` file, and ``--profile`` writes a trace.

The optimizer leaves' order is not written down by hand here: the JAX
package's ``tree_leaves(opt_state)`` decides it, and a leaf in the wrong
place would fail the resumed trajectory. Small sizes: GRU-16, L=10, B=8.

Tolerances: parameters 5 steps after a cross-load within 1e-5, absolute
or relative (rtol 1e-5, atol 1e-5: the same f32 math summed in other
orders; Adam's division by sqrt(nu) magnifies the rounding of the input
table's near-zero gradient entries to a few 1e-6 over 10 steps at lr
0.01); loaded optimizer leaves and checkpoint files exactly.
"""

import copy
import os
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.models.base as base
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.models.base import pytree_load as jax_pytree_load
from seqrec_tpu_torch.data import DataHandler

BASE = ["-m", "RNN", "--loss", "CCE", "--r_l", "16", "--max_length", "10", "-b", "8"]
OPTIMIZERS = {
    "adagrad": ["--u_m", "adagrad", "--u_l", "0.05"],
    "adadelta": ["--u_m", "adadelta", "--u_l", "1.0", "--u_rho", "0.9"],
    "rmsprop": ["--u_m", "rmsprop", "--u_l", "0.01", "--u_rho", "0.9"],
    "nesterov": ["--u_m", "nesterov", "--u_l", "0.05", "--u_rho", "0.9"],
    "adam": ["--u_m", "adam", "--u_l", "0.01"],
    "adam-lazy": ["--u_m", "adam", "--u_l", "0.01", "--lazy_updates"],
    "adam-lazy-bpr": ["--u_m", "adam", "--u_l", "0.01", "--lazy_updates", "--loss", "BPR", "--sampling", "16"],
}


def _pair(dataset_dir, flags):
    argv = BASE + flags
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    jm, tm = jax_parse.get_predictor(jax_args), parse.get_predictor(args)
    jm.prepare_model(JaxDataHandler(dataset_dir))
    jm.set_dataset(JaxDataHandler(dataset_dir))
    handler = DataHandler(dataset_dir)
    tm.prepare_model(handler)
    tm.set_dataset(handler)
    jm.save_optimizer_state = tm.save_optimizer_state = True
    return jm, tm, handler


def _batches(model, handler, n, seed=5):
    gen = model._gen_packed_mini_batch(handler.training_set, np.random.default_rng(seed))
    return [next(gen) for _ in range(n)]


def _jax_start(jm, tree):
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)


def _assert_params(got, want, prefix=""):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_params(got[key], want[key], prefix + key + "/")
        else:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=1e-5, err_msg=prefix + key)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_state_resumes_from_jax_in_the_port(synthetic_dataset, tmp_path, opt):
    """JAX: 5 steps, save with its opt leaves; the port loads and takes the
    next 5 steps; JAX takes them too from its own state."""
    jm, tm, handler = _pair(synthetic_dataset, OPTIMIZERS[opt])
    tree = jm._init_params()
    tm._init_params()  # the model generators advance alike (the sampled head's negatives follow)
    batches = _batches(tm, handler, 10)
    _jax_start(jm, tree)
    for b in batches[:5]:
        jm.train_function(dict(b))
    path = str(tmp_path / "jax.npz")
    jm.save(path)
    n_leaves = len(jax.tree_util.tree_leaves(jm.opt_state))
    assert len(jax_pytree_load(path)["opt"]) == n_leaves
    tm.load(path)
    for (holder, key), leaf in zip(tm._opt_layout(tm.opt_state), jax.tree_util.tree_leaves(jm.opt_state)):
        got = holder[key]
        np.testing.assert_array_equal(np.asarray(got if isinstance(got, int) else got.numpy()), np.asarray(leaf))
    for b in batches[5:]:
        jm.train_function(dict(b))
        tm.train_function(dict(b))
    _assert_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_state_resumes_from_the_port_in_jax(synthetic_dataset, tmp_path, opt):
    """The port: 5 steps, save; JAX loads and takes the next 5 steps; the
    port takes them too."""
    jm, tm, handler = _pair(synthetic_dataset, OPTIMIZERS[opt])
    tree = jm._init_params()
    tm._init_params()
    tm.params_from_numpy(copy.deepcopy(tree))
    batches = _batches(tm, handler, 10)
    for b in batches[:5]:
        tm.train_function(dict(b))
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm.load(path)
    assert jm.opt_state is not None
    for b in batches[5:]:
        jm.train_function(dict(b))
        tm.train_function(dict(b))
    _assert_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))


def test_jax_bf16_moment_checkpoint_loads_without_ml_dtypes(synthetic_dataset, tmp_path, monkeypatch):
    """A JAX-written --u_moments bfloat16 checkpoint with opt leaves loads in
    the port with ml_dtypes unimportable: the moments arrive as bf16
    tensors, bit for bit, and the next step's parameters agree (the step
    math is f32 from those moments; only the stored moments' rounding
    noise differs between the packages)."""
    jm, tm, handler = _pair(synthetic_dataset, ["--u_m", "adam", "--u_l", "0.01", "--u_moments", "bfloat16"])
    tree = jm._init_params()
    batches = _batches(tm, handler, 4)
    _jax_start(jm, tree)
    for b in batches[:3]:
        jm.train_function(dict(b))
    path = str(tmp_path / "jax_bf16.npz")
    jm.save(path)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _  # noqa: F401
    tm.load(path)
    leaves = jax.tree_util.tree_leaves(jm.opt_state)
    refs = tm._opt_layout(tm.opt_state)
    assert len(refs) == len(leaves) and tm.opt_state["count"] == 3
    for (holder, key), leaf in zip(refs[1:], leaves[1:]):
        assert holder[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(holder[key].view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))
    jm.train_function(dict(batches[3]))
    tm.train_function(dict(batches[3]))
    _assert_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))


def test_port_bf16_leaves_load_in_jax_bit_for_bit(synthetic_dataset, tmp_path):
    """The port writes a bf16 moment as the JAX package's marker format
    (uint16 view, ``#dtype=bfloat16``), and reads the legacy ``#bf16``."""
    jm, tm, handler = _pair(synthetic_dataset, ["--u_m", "adam", "--u_l", "0.01", "--u_moments", "bfloat16"])
    tm.params_from_numpy(tm._init_params())
    for b in _batches(tm, handler, 3):
        tm.train_function(dict(b))
    path = str(tmp_path / "port_bf16.npz")
    tm.save(path)
    with np.load(path) as data:
        assert sum(k.endswith("#dtype=bfloat16") for k in data.files) == 2 * len(list(tm.net.parameters()))
    loaded = jax_pytree_load(path)["opt"]
    for i, leaf in enumerate(tm._opt_leaves()):
        got = loaded[str(i)]
        if isinstance(leaf, torch.Tensor):
            assert got.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(np.asarray(got).view(np.int16), leaf.view(torch.int16).numpy())
    legacy = str(tmp_path / "legacy.npz")
    moments = np.linspace(-2, 2, 7, dtype=np.float32).astype(ml_dtypes.bfloat16)
    np.savez(legacy, **{"opt/0#bf16": moments.view(np.uint16)})
    got = base.pytree_load(legacy)["opt"]["0"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), moments.astype(np.float32))


# ----------------------------------------------------------------------
# the async save queue
# ----------------------------------------------------------------------
def _record_writes(monkeypatch):
    writes = []
    save = base.pytree_save

    def recording(filename, tree):
        writes.append((os.path.basename(filename), threading.current_thread() is threading.main_thread()))
        save(filename, tree)

    monkeypatch.setattr(base, "pytree_save", recording)
    return writes


def _train(dataset_dir, flags, save_dir, autosave, sync, max_iter=30):
    _, tm, handler = _pair(dataset_dir, flags)
    if sync:
        save = tm.save
        tm.save = lambda filename, async_write=False: save(filename)
    tm.train(handler, progress=10, max_iter=max_iter, autosave=autosave, save_dir=save_dir)
    return tm


@pytest.mark.parametrize("autosave", ["All", "Best"])
def test_async_saves_write_what_sync_saves_write(synthetic_dataset, tmp_path, monkeypatch, autosave):
    """The same training with the queue and with synchronous saves: the
    same files written in the same order with the same arrays (optimizer
    leaves included); the queue's writes come from its worker thread;
    ``Best`` deletes the dethroned files in both."""
    writes = _record_writes(monkeypatch)
    runs = {}
    for sync in (False, True):
        writes.clear()
        d = str(tmp_path / ("sync" if sync else "async")) + "/"
        _train(synthetic_dataset, ["--u_m", "adam", "--u_l", "0.01"], d, autosave, sync)
        runs[sync] = (list(writes), sorted(os.listdir(d)), d)
    (w_async, files_async, d_async), (w_sync, files_sync, d_sync) = runs[False], runs[True]
    assert [name for name, _ in w_async] == [name for name, _ in w_sync] and len(w_sync) >= 1
    assert not any(main for _, main in w_async) and all(main for _, main in w_sync)
    assert files_async == files_sync
    for name in files_sync:
        with np.load(d_async + name) as a, np.load(d_sync + name) as b:
            assert sorted(a.files) == sorted(b.files) and any(k.startswith("opt/") for k in a.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_async_save_error_is_raised_by_train(synthetic_dataset, tmp_path, monkeypatch):
    def failing(filename, tree):
        raise OSError("disk full")

    monkeypatch.setattr(base, "pytree_save", failing)
    with pytest.raises(OSError, match="disk full"):
        _train(synthetic_dataset, [], str(tmp_path) + "/", "All", sync=False, max_iter=10)


# ----------------------------------------------------------------------
# --save_rank and --profile
# ----------------------------------------------------------------------
def _full_rank_files(d):
    return {name: open(os.path.join(d, "results", name)).read()
            for name in os.listdir(os.path.join(d, "results")) if name.endswith("_full_rank")}


@pytest.mark.parametrize(
    "flags",
    [BASE, ["-m", "LTM", "-H", "8", "--ltm_window", "3", "-l", "0.05"]],
    ids=["rnn", "ltm"],
)
def test_save_rank_writes_the_jax_full_rank_file(synthetic_dataset, tmp_path, flags):
    """The port trains one checkpoint; the JAX test CLI and the port's, each
    with --save --save_rank on it, write the same ``_full_rank`` file (k =
    n_items: past K4's k <= 64, a masked sort of the scores), ties apart:
    a goal item the user had already seen (this dataset repeats items)
    scores -inf, and the JAX package's LTM orders the -inf block by
    ``np.argpartition``, the port (and the JAX package's RNN path, by
    ``lax.top_k``) by item id. Such a line must place the goal inside the
    -inf block on both sides; every other line is equal."""
    d = str(tmp_path / "ds") + "/"
    shutil.copytree(synthetic_dataset, d)
    torch_train_cli.main(["-d", d, *flags, "--max_iter", "2" if "LTM" in flags else "20", "--progress",
                          "2" if "LTM" in flags else "20", "--save", "All", "--device", "cpu"])
    test_argv = ["-d", d, *flags, "--save", "--save_rank"]
    jax_test_cli.main(test_argv)
    want = _full_rank_files(d)
    shutil.rmtree(d + "results")
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = _full_rank_files(d)
    assert len(want) == 1 and got.keys() == want.keys()
    got_lines, want_lines = next(iter(got.values())).splitlines(), next(iter(want.values())).splitlines()
    handler = DataHandler(d)
    n_items = handler.n_items
    tied = []  # per line: the first position of the -inf block, or None
    for sequence, _ in handler.test_set(epochs=1):
        half = len(sequence) // 2
        seen = {int(i[0]) for i in sequence[:half]}
        tied += [n_items - len(seen) if int(i[0]) in seen else None for i in sequence[half:]]
    assert len(got_lines) == len(want_lines) == len(tied) > 0
    for g, w, block in zip(got_lines, want_lines, tied):
        if block is None or "RNN" in flags:
            assert g == w
        else:
            assert g.split("\t")[0] == w.split("\t")[0]
            assert block <= int(g.split("\t")[1]) < n_items and block <= int(w.split("\t")[1]) < n_items
    assert sum(b is not None for b in tied) > 0


def test_profile_writes_a_trace(synthetic_dataset, tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    torch_train_cli.main(["-d", synthetic_dataset, *BASE, "--max_iter", "4", "--progress", "4", "--save", "None",
                          "--profile", trace_dir, "--device", "cpu"])
    assert "Profiler trace written to " + trace_dir in capsys.readouterr().out
    import json

    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
