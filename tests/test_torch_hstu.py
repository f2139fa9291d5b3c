"""The HSTU tower (``--r_t HSTU``) on the CPU against the plain reference
(``seqrec_tpu_torch/reference/hstu.py``), at d 16, 2 blocks, 2 heads of
dqk = dv = 8, B 6, L 12, 300 items, with rows of 1, 12 and between valid
steps: the attention op's plain version (causal and padding masks, the
rab's bucket edges and its gradients), the tower and CCE head's cost,
every leaf's gradient and three Adam steps, and the flags, the file name,
an ``.npz`` round trip and both CLIs. The tower on packed tokens against
the same parameters run over every padded step (:func:`_padded_tower`), at
full rows, mixed lengths with empty rows, rows of one step and one row.

Tolerances: both sides are float32 on the CPU and differ in the order of
some sums (the head's log-sum-exp, the gather-sum, the bias's table
lookups): costs within 1e-6 relative, gradients within 1e-5 of each
leaf's largest entry; a TF32 product (a tenth of a percent) would miss
both by two orders of magnitude. Parameters after three Adam steps at lr
1e-3 within 1e-6 (a thousandth of a step): Adam's first steps move each
entry by about lr, whatever the gradient's size, so a gradient entry that
rounds to the other sign moves its parameter by 2 lr; none does here.
"""

import io
import math
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch.nn import functional as F

import seqrec_tpu_torch.cli.test as test_cli
import seqrec_tpu_torch.cli.train as train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models.hstu import HSTULayers
from seqrec_tpu_torch.ops import hstu_attention as op
from seqrec_tpu_torch.ops.gather_sum import gather_sum
from seqrec_tpu_torch.reference import hstu as ref

D, BLOCKS, HEADS, DK, L, B = 16, 2, 2, 8, 12, 6
CFG = {"blocks": BLOCKS, "heads": HEADS, "dqk": DK, "dv": DK}
FLAGS = ["-m", "RNN", "--r_t", "HSTU", "--r_l", str(D), "--hstu_blocks", str(BLOCKS), "--hstu_heads", str(HEADS),
         "--hstu_dqk", str(DK), "--hstu_dv", str(DK), "--max_length", str(L), "-b", str(B), "--u_m", "adam",
         "--u_l", "0.001"]
LENGTHS = [1, 12, 5, 7, 2, 12]
COST_RTOL = 1e-6
GRAD_ATOL_REL = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("hstu")), n_users=150, n_items=300, min_len=8, max_len=30,
                        n_val_users=10, n_test_users=10, seed=4)


def _predictor(dataset_dir, extra=()):
    args = parse.command_parser(parse.predictor_command_parser, argv=FLAGS + ["--loss", "CCE", *extra])
    args.device = "cpu"
    model = parse.get_predictor(args)
    handler = DataHandler(dataset_dir)
    model.prepare_model(handler)
    model.set_dataset(handler)
    model.params_from_numpy(model._init_params())
    return model


def _batch(model, seed=5):
    rng = np.random.default_rng(seed)
    lengths = torch.tensor(LENGTHS)
    mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
    ids = torch.from_numpy(rng.integers(0, model.n_items, size=(B, L, 1))).int() * mask[..., None].int()
    targets = torch.from_numpy(rng.integers(0, model.n_items, size=B)).long()
    pop = torch.from_numpy((model.dataset.item_popularity ** model.diversity_bias).astype(np.float32))
    return {"ids": ids, "mask": mask, "targets": targets, "target_pop": pop[targets]}, lengths, pop


def _ref_params(model):
    return {k.removeprefix("tower."): v.detach().clone() for k, v in model.net.named_parameters()}


def _close(got, want, atol_rel):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) <= atol_rel * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("lengths", [[1, 12, 5], [12, 12, 12], [2, 1, 7]], ids=["mixed", "full", "short"])
def test_attention_plain_version_against_the_reference(lengths):
    """Output and the gradients of q, k, v and both rab tables, with the
    causal and padding masks: rows of 1 and 12 valid steps and between."""
    g = torch.Generator().manual_seed(sum(lengths))
    q, k, v = (torch.randn(3, L, HEADS * DK, generator=g, requires_grad=True) for _ in range(3))
    p = torch.randn(2 * L - 1, generator=g, requires_grad=True)
    w = torch.randn(op.RAB_BUCKETS + 1, generator=g, requires_grad=True)
    m = torch.tensor(lengths)
    up = torch.randn(3, L, HEADS * DK, generator=g)
    leaves = [q, k, v, p, w]
    got = op.hstu_attention(q, k, v, p, w, m, HEADS, 1.0 / L)
    want = ref.attention(q, k, v, ref.rab(p, w, torch.arange(L)), m, HEADS)
    assert _close(got, want, 1e-6)
    pad = torch.arange(L)[None, :, None] >= m[:, None, None]
    assert not got.masked_select(pad).any()  # no valid pair: padded rows are 0
    for a, b in zip(torch.autograd.grad((got * up).sum(), leaves), torch.autograd.grad((want * up).sum(), leaves)):
        assert _close(a, b, 1e-6)


def test_rab_bucket_edges_and_bias_gradients():
    """HSTU's buckets min(floor(ln(max(gap, 1)) / 0.301), 128) at and
    around each edge e^(0.301 n), against float64 arithmetic; the [L] bias
    against the reference's [L, L] matrix on the causal pairs; and
    rab_grads (the gather sum) against autograd through rab_bias."""
    gaps = torch.arange(0, 200_000)
    want = np.minimum(np.floor(np.log(np.maximum(gaps.numpy(), 1).astype(np.float64)) / 0.301), 128)
    assert np.array_equal(op.time_buckets(gaps).numpy(), want)
    assert op.time_buckets(torch.tensor([0, 1, 2, 3, 4, 6, 9, 11, 15, 16, 50, 51])).tolist() == [
        0, 0, 2, 3, 4, 5, 7, 7, 8, 9, 12, 13]
    Lr = 200  # every bucket the cell's rows reach (0 .. 17)
    g = torch.Generator().manual_seed(1)
    p = torch.randn(2 * Lr - 1, generator=g, requires_grad=True)
    w = torch.randn(op.RAB_BUCKETS + 1, generator=g, requires_grad=True)
    bias = op.rab_bias(p, w, Lr)
    full = ref.rab(p, w, torch.arange(Lr))
    i = torch.arange(Lr)
    r = (i[:, None] - i[None, :]).clamp(min=0)
    causal = i[None, :] <= i[:, None]
    assert torch.equal(torch.where(causal, bias[r], 0.0), torch.where(causal, full, 0.0))
    d_bias = torch.randn(Lr, generator=g)
    d_p, d_w = op.rab_grads(d_bias, p.shape[0], Lr)
    want_p, want_w = torch.autograd.grad((bias * d_bias).sum(), [p, w])
    assert torch.allclose(d_p, want_p, atol=1e-6) and torch.allclose(d_w, want_w, atol=1e-5)
    assert d_w[18:].abs().sum() == 0 and d_p[Lr:].abs().sum() == 0  # j > i never meets the bias


@pytest.mark.parametrize("db", [0.0, 0.5])
def test_tower_and_head_against_the_reference(dataset, db):
    """The port's tower and CCE head (``_loss``) against the reference's
    cost and autograd: the cost and every leaf's gradient."""
    model = _predictor(dataset, ["--db", str(db)])
    batch, lengths, pop = _batch(model)
    params = [p for _, p in model.net.named_parameters()]
    cost = model._loss(batch)
    got = dict(zip([k.removeprefix("tower.") for k, _ in model.net.named_parameters()],
                   torch.autograd.grad(cost, params)))
    ids = batch["ids"][..., 0].long()
    want_cost, want = ref.grads(_ref_params(model), CFG, ids, lengths, batch["targets"], pop)
    assert math.isclose(float(cost.detach()), float(want_cost), rel_tol=COST_RTOL)
    assert set(got) == set(want) and len(got) == 2 + 5 * BLOCKS + 2
    for key in want:
        assert _close(got[key], want[key], GRAD_ATOL_REL), key


def test_three_adam_steps_against_the_reference(dataset):
    model = _predictor(dataset)
    batch, lengths, pop = _batch(model)
    params = _ref_params(model)
    ids = batch["ids"][..., 0].long()
    state: dict = {}
    for _ in range(3):
        got_cost = model._step(dict(batch))
        want_cost, grads = ref.grads(params, CFG, ids, lengths, batch["targets"], pop)
        assert math.isclose(float(got_cost), float(want_cost), rel_tol=COST_RTOL)
        ref.adam_step(params, grads, state, 1e-3, 0.9, 0.999, 1e-8)
    got = _ref_params(model)
    for key in params:
        assert torch.allclose(got[key], params[key], rtol=0, atol=PARAM_ATOL), key


def _padded_tower(tower, inputs, mask, id_mask, only_return_final=True):
    """The tower's math over every step of the padded [B, L] layout, the
    output read at step max(m - 1, 0)."""
    B, L = mask.shape
    lengths = mask.sum(dim=1).round().long()
    d, hq, hv = tower.hidden, tower.heads * tower.dqk, tower.heads * tower.dv
    x = math.sqrt(d) * gather_sum(tower.embedding, inputs, id_mask) + tower.pos[:L]
    for b in range(tower.blocks):
        p = getattr(tower, f"block{b}")
        uvqk = F.silu(F.layer_norm(x, (d,), eps=1e-6) @ p["W_uvqk"])
        u, v, q, k = torch.split(uvqk, [hv, hv, hq, hq], dim=-1)
        o = op.hstu_attention(q, k, v, p["rab_p"], p["rab_w"], lengths, tower.heads, 1.0 / L)
        x = x + (F.layer_norm(o, (hv,), eps=1e-6) * u) @ p["W_o"] + p["b_o"]
    if not only_return_final:
        return x
    return x[torch.arange(B), torch.clamp(lengths - 1, min=0)]


PACKED_MIXES = {"full": [L, L, L], "mixed_empty": [0, 12, 5, 0, 7, 1], "ones": [1, 1, 1, 1], "one_row": [5]}


def _packed_case(lengths, dv, seed=11):
    """A tower of 2 heads with dqk 8 and dv 8 (V, Q, K in three padded
    buffers) or 4 (in one), random parameters (b_o too), two id slots a
    step with pad slots and an id_mask, and ids at the padded steps as
    well."""
    tower = HSTULayers(hidden=D, blocks=BLOCKS, heads=HEADS, dqk=DK, dv=dv, max_length=L + 3)
    tower.build(50, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    m = torch.tensor(lengths)
    mask = (torch.arange(L)[None, :] < m[:, None]).float()
    ids = torch.randint(-1, 50, (len(lengths), L, 2), generator=g).int()
    id_mask = torch.rand(len(lengths), L, 2, generator=g)
    return tower, m, ids, mask, id_mask


@pytest.mark.parametrize("dv", [DK, DK // 2], ids=["dv8", "dv4"])
@pytest.mark.parametrize("lengths", list(PACKED_MIXES.values()), ids=list(PACKED_MIXES))
def test_packed_tower_against_the_padded_layout(lengths, dv):
    """The output and every leaf's gradient of the tower on packed tokens
    equal the padded computation's (float32, the same ops a token; only the
    weight gradients' sums run in another order), and the counters rise by
    sum(max(m, 1)) and B L."""
    tower, m, ids, mask, id_mask = _packed_case(lengths, dv)
    leaves = list(tower.parameters())
    got = tower(ids, mask, id_mask)
    want = _padded_tower(tower, ids, mask, id_mask)
    assert got.shape == want.shape == (len(lengths), D)
    assert _close(got, want, 1e-6)
    up = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    for (name, _), a, b in zip(tower.named_parameters(), torch.autograd.grad((got * up).sum(), leaves),
                               torch.autograd.grad((want * up).sum(), leaves)):
        assert _close(a, b, GRAD_ATOL_REL), name
    assert tower.tokens_run == int(torch.clamp(m, min=1).sum()) and tower.tokens_padded == len(lengths) * L
    tower(ids, mask, id_mask)
    assert tower.tokens_run == 2 * int(torch.clamp(m, min=1).sum()) and tower.tokens_padded == 2 * len(lengths) * L


@pytest.mark.parametrize("dv", [DK, DK // 2], ids=["dv8", "dv4"])
@pytest.mark.parametrize("lengths", list(PACKED_MIXES.values()), ids=list(PACKED_MIXES))
def test_packed_tower_every_step(lengths, dv):
    """``only_return_final=False``: [B, L, d] equal to the padded
    computation at the valid steps and at step 0 of an empty row (the step
    its output reads), zeros at every other padded step."""
    tower, m, ids, mask, id_mask = _packed_case(lengths, dv, seed=12)
    got = tower(ids, mask, id_mask, only_return_final=False)
    want = _padded_tower(tower, ids, mask, id_mask, only_return_final=False)
    kept = torch.arange(L)[None, :] < torch.clamp(m, min=1)[:, None]
    assert got.shape == want.shape == (len(lengths), L, D)
    assert _close(got[kept], want[kept], 1e-6)
    assert not got[~kept].any()


def test_flags_name_and_checkpoint_round_trip(dataset, tmp_path):
    model = _predictor(dataset)
    tower = model.recurrent_layer
    assert isinstance(tower, HSTULayers) and tower.output_size == D
    assert (tower.blocks, tower.heads, tower.dqk, tower.dv, tower.max_length) == (BLOCKS, HEADS, DK, DK, L)
    name = model._get_model_filename(3)
    assert name.startswith("rnn_cce_db0.0_r0.0_ml12_bs6_ne3_")
    assert f"_HSTU_b{BLOCKS}_nh{HEADS}_qk{DK}_v{DK}_h{D}_" in name
    shapes = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    assert shapes["tower.pos"] == (L, D) and shapes["tower.block1.W_uvqk"] == (D, 2 * HEADS * 2 * DK)
    assert shapes["tower.block0.rab_p"] == (2 * L - 1,) and shapes["tower.block0.rab_w"] == (129,)
    path = str(tmp_path / "hstu.npz")
    model.save(path)
    other = _predictor(dataset)
    with torch.no_grad():
        for p in other.net.parameters():
            p.add_(1.0)
    other.load(path)
    for key, value in model.net.state_dict().items():
        assert torch.equal(other.net.state_dict()[key], value), key
    with pytest.raises(ValueError):
        parse.get_predictor(parse.command_parser(parse.predictor_command_parser, argv=FLAGS + ["--r_bi"]))


@pytest.mark.parametrize("extra, mesh", [(["--r_emb", "8"], ""), (["--bf16"], ""), ([], "1,1")],
                         ids=["r_emb", "bf16", "mesh"])
def test_untested_combinations_are_refused(extra, mesh):
    """HSTU runs in float32 on one device: --r_emb, --bf16 and --mesh are
    refused where the tower is built, before any device or mesh is set up."""
    args = parse.command_parser(parse.predictor_command_parser, argv=FLAGS + extra)
    args.mesh = mesh
    with pytest.raises(ValueError):
        parse.get_predictor(args)


@pytest.mark.parametrize("head", [["--loss", "CCE"], ["--loss", "BPR", "--sampling", "16"], ["--loss", "hinge"],
                                  ["--loss", "CCE", "--lazy_updates"]], ids=["cce", "bpr", "hinge", "cce_lazy"])
def test_train_and_test_clis(dataset, head):
    """``--r_t HSTU`` trains through the train CLI at --spd 2 (the index
    wire, the stacked dispatch) under each family of heads and with the
    item table on the lazy Adam, writes its checkpoints, and the test CLI
    scores them."""
    flags = FLAGS + head
    sub = "hstu_" + "_".join(a.strip("-").lower() for a in head[1:]) + "/"
    out = io.StringIO()
    with redirect_stdout(out):
        train_cli.main(["-d", dataset, *flags, "--max_iter", "24", "--progress", "12", "--save", "All", "--dir", sub,
                        "--spd", "2", "--device", "cpu"])
    costs = [float(ln.split(":")[1]) for ln in out.getvalue().splitlines() if ln.startswith("Last train cost")]
    assert len(costs) == 2 and all(math.isfinite(c) for c in costs)
    names = sorted(os.listdir(os.path.join(dataset, "models", sub)))
    assert names and all("_HSTU_b2_nh2_qk8_v8_h16_" in n for n in names)
    out = io.StringIO()
    with redirect_stdout(out):
        test_cli.main(["-d", dataset, *flags, "--dir", sub, "--device", "cpu"])
    assert "sps@10" in out.getvalue() or "sps" in out.getvalue()
