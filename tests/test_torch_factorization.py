"""The port's factorization family (BPRMF, FPMC, FISM, Fossil) against the
JAX package's on the CPU, at a small size (60 users, 40 items, k = 8):

- each SGD chunk against the JAX static method on the same tables and
  ids, with colliding users and items and a sample whose j is another
  sample's i (rtol/atol 1e-6);
- the initial tables from one seed (exactly);
- 20 training steps on the host-sampling paths: the same samples bit for
  bit, the same generator state after them, the step costs and the tables
  within rtol/atol 1e-5 (sums of colliding rows in another order);
- the device samplers (run here on the CPU): membership equal to the CSR
  test, no negative in the user's history, the adaptive draw's total
  variation distance to the host oracle under the JAX package's own bound
  (``tests/test_factorization.py``), the length buckets partitioning the
  eligible users, FISM's and Fossil's device sub-chunks handing the SGD
  chunk the host sampler's kind of sample (leave-one-out baskets, prefix
  baskets with their last items; cuts, users and negatives uniform by a
  chi-square test), whole dispatches finite and repeatable from the seed;
- ``top_k_batch`` by the host route (the JAX package's lists exactly) and
  by the device route with ``DEVICE_TOPK_MIN_ITEMS`` lowered on the
  instance (K4's plain version here; the same lists where no two scores
  tie within 1e-5, the same scores where they do);
- empty bags score finite; host copies follow in-place updates; the
  tables set from numpy arrays are copies of them;
- ``.npz`` checkpoints and file names read by the other package; the
  train CLI's checkpoint scored by both packages' test CLIs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.cli.train as jax_train_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.data.synthetic import make_dataset
from seqrec_tpu.models import factorization as jf
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.models import factorization as tf

CHUNK = dict(rtol=1e-6, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)

SPEC = {
    "bprmf": ("BPRMF", dict(k=8, adaptive_sampling=False, learning_rate=0.1, init_sigma=0.3)),
    "bprmf_adaptive": ("BPRMF", dict(k=8, sampling_bias=10, learning_rate=0.1, init_sigma=0.3)),
    "fpmc": ("FPMC", dict(k_cf=8, k_mc=8, adaptive_sampling=False, learning_rate=0.1, init_sigma=0.3)),
    "fpmc_adaptive": ("FPMC", dict(k_cf=8, k_mc=8, sampling_bias=10, learning_rate=0.1, init_sigma=0.3)),
    "fism_bpr": ("FISM", dict(k=8, loss="BPR", learning_rate=0.05, init_sigma=0.3, reg=0.01)),
    "fism_rmse": ("FISM", dict(k=8, loss="RMSE", learning_rate=0.05, init_sigma=0.3, reg=0.01)),
    "fossil": ("Fossil", dict(k=8, order=2, learning_rate=0.05, init_sigma=0.3, reg=0.01)),
}
ONE_EACH = ["bprmf", "fpmc", "fism_bpr", "fossil"]


@pytest.fixture(autouse=True)
def one_thread():
    """CPU ``index_add_`` of rows 16 floats wide or more takes a parallel
    path that stalls for tens of ms a call when other processes share the
    cores; these small scatters run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mf_dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("mf")), n_users=60, n_items=40, min_len=5, max_len=20, seed=3)


def _pair(name, dataset_dir, seed=5, **over):
    cls, kwargs = SPEC[name]
    kwargs = {**kwargs, **over}
    jm = getattr(jf, cls)(seed=seed, **kwargs)
    tm = getattr(tf, cls)(seed=seed, device="cpu", **kwargs)
    for model, handler in ((jm, JaxDataHandler(dataset_dir)), (tm, DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.change_data_format(handler)
        model.init_model()
    return jm, tm


def _share(jm, tm):
    """The port's tables into the JAX model."""
    for name, arr in tm.params_to_numpy().items():
        setattr(jm, name, jnp.asarray(arr))


def _assert_same_tables(jm, tm, **tol):
    for name in tm._PARAMS:
        np.testing.assert_allclose(tm._np(name), np.asarray(getattr(jm, name)), err_msg=name, **tol)


@pytest.mark.parametrize("name", ONE_EACH)
def test_init_matches_jax(mf_dataset, name):
    jm, tm = _pair(name, mf_dataset)
    for p in tm._PARAMS:
        got = getattr(tm, p)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, p)), err_msg=p)
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state
    np.testing.assert_array_equal(tm.users, jm.users)
    np.testing.assert_array_equal(tm._eligible_users, jm._eligible_users)


def _chunk_inputs(name, seed=11):
    """Tables and colliding ids: 24 samples over 4 users and 6 items; sample
    0's j is sample 1's i, sample 2 has i = j; baskets of up to 8 slots over
    the same 6 items, with pads."""
    rng = np.random.default_rng(seed)
    n, N, U, k = 24, 10, 6, 5
    u = rng.integers(0, 4, n)
    i = rng.integers(0, 6, n)
    j = rng.integers(0, 6, n)
    j[0], j[2] = i[1], i[2]
    tables = {
        "V": rng.normal(size=(U if name == "bprmf" else N, k)), "H": rng.normal(size=(N, k)),
        "bias": rng.normal(size=N), "eta": rng.normal(size=(U, 2)), "eta_bias": rng.normal(size=2),
        "VUI": rng.normal(size=(U, k)), "VIU": rng.normal(size=(N, k)), "VPN": rng.normal(size=(N, 3)),
        "VNP": rng.normal(size=(N, 3)),
    }
    tables = {key: v.astype(np.float32) for key, v in tables.items()}
    lens = rng.integers(0, 9, n)
    lens[0] = 0  # an empty basket
    bmask = (np.arange(8)[None, :] < lens[:, None]).astype(np.float32)
    basket = np.where(bmask > 0, rng.integers(0, 6, (n, 8)), -1)
    rmask = (np.arange(2)[None, :] < np.minimum(lens, 2)[:, None]).astype(np.float32)
    recent = np.where(rmask > 0, rng.integers(0, 6, (n, 2)), -1)
    ids = dict(u=u, p=rng.integers(0, 6, n), i=i, j=j, basket=basket, bmask=bmask, recent=recent, rmask=rmask,
               rating=(rng.random(n) < 0.25).astype(np.float32))
    return tables, ids, N


def _jax_pads(arr, N):
    return np.where(arr < 0, N, arr)


@pytest.mark.parametrize("name", ["bprmf", "fpmc", "fism_bpr", "fism_rmse", "fossil"])
def test_sgd_chunk_matches_jax(name):
    tb, ids, N = _chunk_inputs(name)
    reg, alpha, lr = 0.01, 0.3, np.float32(0.07)
    t = {key: torch.from_numpy(v.copy()) for key, v in tb.items()}
    x = {key: torch.from_numpy(v) for key, v in ids.items()}
    J = {key: jnp.asarray(v) for key, v in tb.items()}
    if name == "bprmf":
        *want, want_cost = jf.BPRMF._sgd_chunk(reg, J["V"], J["H"], J["bias"], ids["u"], ids["i"], ids["j"], lr)
        cost = tf.BPRMF._sgd_chunk(reg, t["V"], t["H"], t["bias"], x["u"], x["i"], x["j"], float(lr))
        keys = ("V", "H", "bias")
    elif name == "fpmc":
        names = ("VUI", "VIU", "VPN", "VNP")
        *want, want_cost = jf.FPMC._sgd_chunk(reg, *(J[n] for n in names), ids["u"], ids["p"], ids["i"], ids["j"], lr)
        cost = tf.FPMC._sgd_chunk(reg, *(t[n] for n in names), x["u"], x["p"], x["i"], x["j"], float(lr))
        keys = names
    elif name.startswith("fism"):
        bpr = name == "fism_bpr"
        target = ("i", "j") if bpr else ("i", "rating")
        fn_j = jf.FISM._auc_chunk if bpr else jf.FISM._rmse_chunk
        fn_t = tf.FISM._auc_chunk if bpr else tf.FISM._rmse_chunk
        *want, want_cost = fn_j(reg, alpha, J["V"], J["H"], J["bias"], _jax_pads(ids["basket"], N), ids["bmask"],
                                *(ids[key] for key in target), lr)
        cost = fn_t(reg, alpha, t["V"], t["H"], t["bias"], x["basket"], x["bmask"], *(x[key] for key in target),
                    float(lr))
        keys = ("V", "H", "bias")
    else:
        *want, want_cost = jf.Fossil._sgd_chunk(
            reg, alpha, 2, J["V"], J["H"], J["bias"], J["eta"], J["eta_bias"], _jax_pads(ids["basket"], N),
            ids["bmask"], _jax_pads(ids["recent"], N), ids["rmask"], ids["u"], ids["i"], ids["j"], lr)
        cost = tf.Fossil._sgd_chunk(
            reg, alpha, 2, t["V"], t["H"], t["bias"], t["eta"], t["eta_bias"], x["basket"], x["bmask"], x["recent"],
            x["rmask"], x["u"], x["i"], x["j"], float(lr))
        keys = ("V", "H", "bias", "eta", "eta_bias")
    for key, w in zip(keys, want, strict=True):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(w), err_msg=key, **CHUNK)
        assert np.abs(t[key].numpy() - tb[key]).max() > 1e-4, key
    np.testing.assert_allclose(float(cost), float(want_cost), **CHUNK)


def _jax_host_step(jm, iterations):
    """The JAX package's host-sampling step. Its BPRMF and FPMC draw
    uniform negatives only on the device in ``training_step``; their host
    draw is ``_sample_chunk`` and the jitted chunk."""
    n, lr = jm.samples_per_step, np.float32(jm.learning_rate)
    if isinstance(jm, jf.BPRMF) and not jm.adaptive_sampling:
        jm.V, jm.H, jm.bias, cost = jm._step(jm.V, jm.H, jm.bias, *jm._sample_chunk(n), lr)
        return cost, n
    if isinstance(jm, jf.FPMC) and not jm.adaptive_sampling:
        *tables, cost = jm._step(jm.V_user_item, jm.V_item_user, jm.V_prev_next, jm.V_next_prev,
                                 *jm._sample_chunk(n), lr)
        jm.V_user_item, jm.V_item_user, jm.V_prev_next, jm.V_next_prev = tables
        return cost, n
    jm.device_adaptive = jm.device_sampling = False
    return jm.training_step(iterations)


def _recorded(model, method, log):
    draw = getattr(model, method)

    def recording(n):
        log.append(draw(n))
        return log[-1]

    setattr(model, method, recording)


@pytest.mark.parametrize("name", list(SPEC))
def test_twenty_host_sampled_steps_match_jax(mf_dataset, name):
    jm, tm = _pair(name, mf_dataset)
    tm.device_sampling = tm.device_adaptive = False
    method = "_sample_baskets" if name.startswith("fism") else "_sample_chunk"
    draws_j, draws_t = [], []
    for model, log in ((jm, draws_j), (tm, draws_t)):
        model.samples_per_step = 128
        _recorded(model, method, log)
    it_j = it_t = 0
    costs_j, costs_t = [], []
    for _ in range(20):
        c, n = _jax_host_step(jm, it_j)
        costs_j.append(float(c))
        it_j += n
        c, n = tm.training_step(it_t)
        costs_t.append(float(c))
        it_t += n
    assert it_t == it_j == 20 * 128
    for want, got in zip(draws_j, draws_t, strict=True):
        for w, g in zip(want, got, strict=True):
            w = np.asarray(w)
            if w.ndim == 2 and w.dtype.kind == "i":  # the JAX package's pad id is n_items
                w = np.where(w == jm.n_items, -1, w)
            np.testing.assert_array_equal(g, w)
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state
    np.testing.assert_allclose(costs_t, costs_j, **STEPS)
    _assert_same_tables(jm, tm, **STEPS)


def test_device_member_equals_the_csr_test(mf_dataset):
    _, tm = _pair("bprmf", mf_dataset)
    tm._upload_sample_store()
    users, items = np.meshgrid(np.arange(tm.n_users), np.arange(tm.n_items), indexing="ij")
    users, items = users.ravel(), items.ravel()
    got = tm._device_member(torch.from_numpy(items), torch.from_numpy(users)).numpy()
    want = tm._is_member(users, items)
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)


def test_device_negatives_never_in_history(mf_dataset):
    _, tm = _pair("bprmf", mf_dataset)
    gen = tm._dispatch_generator()
    users = np.tile(tm._eligible_users[:16], 64)
    j = tm._device_negatives(gen, torch.from_numpy(users)).numpy().copy()
    assert ((j >= 0) & (j < tm.n_items)).all() and len(np.unique(j)) > 20
    assert not tm._is_member(users, j).any()


def test_device_adaptive_draw_matches_host_oracle(synthetic_dataset):
    """The JAX package's own check of its device draw, with its bounds
    (tests/test_factorization.py): 12,000 draws for one user, the member
    rate under 2e-3 and the total variation distance to the host sampler
    under 0.08. The port's host sampler draws the JAX package's bits."""
    jm, tm = (cls(k=4, adaptive_sampling=True, sampling_bias=15, init_sigma=0.5, seed=0, **kw)
              for cls, kw in ((jf.BPRMF, {}), (tf.BPRMF, {"device": "cpu"})))
    for model, handler in ((jm, JaxDataHandler(synthetic_dataset)), (tm, DataHandler(synthetic_dataset))):
        model.prepare_model(handler)
        model.change_data_format(handler)
        model.init_model()
        model.compute_factor_rankings()
    users = np.full(12_000, int(tm._eligible_users[0]), dtype=np.int64)
    jm.rng, tm.rng = np.random.default_rng(7), np.random.default_rng(7)
    host = tm._adaptive_negatives(users)
    np.testing.assert_array_equal(host, jm._adaptive_negatives(users))
    gen = tm._dispatch_generator()
    u = torch.from_numpy(users)
    Vu = tm.V[u]
    dev = tm._device_adaptive_draw(
        gen, Vu.abs() * torch.from_numpy(tm.var.astype(np.float32)), torch.sign(Vu),
        torch.from_numpy(tm.ranks), tm._member_reject(u),
    ).numpy().copy()
    assert tm._is_member(users, dev).mean() < 2e-3
    f_host = np.bincount(host, minlength=tm.n_items) / len(users)
    f_dev = np.bincount(dev, minlength=tm.n_items) / len(users)
    assert 0.5 * np.abs(f_host - f_dev).sum() < 0.08
    # the device rank tables equal the host's (the variances to f32 rounding)
    tm._device_rank_refresh()
    np.testing.assert_array_equal(tm._dev_ranks.numpy(), tm.ranks)
    np.testing.assert_allclose(tm._dev_var.numpy(), tm.var, rtol=1e-6)


def test_fpmc_device_adaptive_draw_excludes_the_true_item(mf_dataset):
    _, tm = _pair("fpmc_adaptive", mf_dataset)
    tm._device_rank_refresh()
    gen = tm._dispatch_generator()
    tm.samples_per_step = 2048
    u, p, i = tm._device_sample(gen)
    concat = torch.cat([tm.V_user_item[u], tm.V_prev_next[p]], 1)
    j = tm._device_adaptive_draw(gen, concat.abs() * tm._dev_var, torch.sign(concat), tm._dev_ranks,
                                 lambda cand: cand == i[None, :])
    assert not (j == i).any() and ((j >= 0) & (j < tm.n_items)).all()
    tm.compute_factor_rankings()
    np.testing.assert_array_equal(tm._dev_ranks.numpy(), tm.ranks)


def test_bucket_store_partitions_eligible_users(mf_dataset):
    jm, tm = _pair("fism_bpr", mf_dataset)
    tm._upload_bucket_store()
    jm._upload_bucket_store()
    assert sorted(tm._bucket_users) == sorted(jm._bucket_users)
    users = np.concatenate([u.numpy() for u in tm._bucket_users.values()])
    assert sorted(users) == sorted(tm._eligible_users)
    assert np.isclose(sum(tm._bucket_probs.values()), 1.0) and tm._bucket_probs == jm._bucket_probs
    for P, u in tm._bucket_users.items():
        np.testing.assert_array_equal(u.numpy(), np.asarray(jm._bucket_users[P]))
        lens = tm.users[u.numpy(), 1]
        assert (lens <= P).all() and (lens >= 2).all()
    assert [tm._draw_bucket() for _ in range(20)] == [jm._draw_bucket() for _ in range(20)]


def _device_sub_chunk_samples(tm, dispatches):
    """What the device sub-chunks of ``dispatches`` dispatches hand to the
    SGD chunk, as numpy arrays, with the users that ``_device_baskets``
    drew for each (the tables stay untouched)."""
    log, users = [], []
    draw = tm._device_baskets

    def baskets(*a):
        out = draw(*a)
        users.append(out[0].numpy().copy())
        return out

    def record(*args):
        log.append([a.numpy().copy() if torch.is_tensor(a) else a for a in args])
        return torch.zeros(())

    tm._device_baskets = baskets
    tm._sgd_chunk = tm._auc_chunk = tm._rmse_chunk = record
    for d in range(dispatches):
        tm.training_step(d)
    return log, users


def _columns(log, pick, fill):
    """The sub-chunks' arguments at positions ``pick``, each joined over the
    sub-chunks; 2-D ones padded to the widest bucket with ``fill``."""
    out = []
    for n, parts in zip(pick, zip(*[[args[p] for p in pick] for args in log])):
        width = max(a.shape[1] for a in parts) if parts[0].ndim == 2 else None
        if width is not None:
            parts = [np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=fill[n]) for a in parts]
        out.append(np.concatenate(parts))
    return out


def _chi2_of_uniform_index(idx, n, bins=4):
    """Pearson's statistic of ``idx`` [m], each drawn uniformly from
    {0, ..., n - 1} for its own n [m], binned by floor(bins * idx / n); the
    expected counts are exact for each n."""
    got = np.bincount(bins * idx // n, minlength=bins)
    want = np.zeros(bins)
    for size, count in zip(*np.unique(n, return_counts=True)):
        want += count * np.bincount(bins * np.arange(size) // size, minlength=bins) / size
    return float(((got - want) ** 2 / want).sum())


def _non_member_index(tm, users, j):
    """The rank of each negative j among the items outside user u's history."""
    hist = tm._user_item.toarray() > 0
    rank = np.cumsum(~hist, axis=1) - 1
    return rank[users, j], (~hist).sum(1)[users]


def test_fossil_device_samples_are_prefixes_drawn_uniformly(mf_dataset):
    """The device sub-chunk's samples are the host sampler's kind: a cut t
    uniform in [1, len), the basket the t items before it, the target item
    t, the last ``order`` basket items most recent first, the user's own
    eta row, a negative uniform outside the history; users uniform within
    the dispatch's length bucket (chi-square, 3 degrees of freedom, < 20)."""
    _, tm = _pair("fossil", mf_dataset)
    log, drawn = _device_sub_chunk_samples(tm, 2)
    assert len(log) == 2 * tm.chunks_per_dispatch * tm.sub_chunks
    basket, bmask, recent, rmask, u, i, j = _columns(log, range(8, 15), {8: -1, 9: 0, 10: -1, 11: 0})
    np.testing.assert_array_equal(u, np.concatenate(drawn))
    offs, lens = tm.users[u, 0], tm.users[u, 1]
    t = bmask.sum(1).astype(np.int64)
    assert ((t >= 1) & (t < lens)).all()
    slots = np.arange(basket.shape[1])[None, :]
    np.testing.assert_array_equal(bmask, (slots < t[:, None]).astype(np.float32))
    np.testing.assert_array_equal(basket, np.where(slots < t[:, None], tm.items[np.minimum(offs[:, None] + slots, len(tm.items) - 1)], -1))
    np.testing.assert_array_equal(i, tm.items[offs + t])
    k = np.arange(tm.order)[None, :]
    np.testing.assert_array_equal(rmask, (k < t[:, None]).astype(np.float32))
    np.testing.assert_array_equal(recent, np.where(k < t[:, None], tm.items[offs[:, None] + t[:, None] - 1 - k], -1))
    assert not tm._is_member(u, j).any()
    assert _chi2_of_uniform_index(t - 1, lens - 1) < 20
    assert _chi2_of_uniform_index(*_non_member_index(tm, u, j)) < 20
    for d in range(2):
        part = np.concatenate(drawn[d * len(drawn) // 2 : (d + 1) * len(drawn) // 2])
        [pool] = [p.numpy() for p in tm._bucket_users.values() if np.isin(part, p.numpy()).all()]
        assert _chi2_of_uniform_index(np.searchsorted(np.sort(pool), part), np.full(len(part), len(pool))) < 20


@pytest.mark.parametrize("name", ["fism_bpr", "fism_rmse"])
def test_fism_device_samples_leave_the_target_out(mf_dataset, name):
    """FISM's device baskets: the user's whole history with every slot that
    holds the target item masked out, the target from the history, a
    negative uniform outside it (chi-square < 20); RMSE's 1:3 mix of
    targets (rating 1) and negatives (rating 0)."""
    _, tm = _pair(name, mf_dataset)
    log, drawn = _device_sub_chunk_samples(tm, 2)
    u = np.concatenate(drawn)
    basket, bmask, item, other = _columns(log, range(5, 9), {5: -1, 6: 0})
    offs, lens = tm.users[u, 0], tm.users[u, 1]
    slots = np.arange(basket.shape[1])[None, :]
    hist = np.where(slots < lens[:, None], tm.items[np.minimum(offs[:, None] + slots, len(tm.items) - 1)], -1)
    pos = np.ones(len(u), bool) if name == "fism_bpr" else other == 1.0
    if name == "fism_rmse":
        assert set(np.unique(other)) == {0.0, 1.0} and abs(pos.mean() - 0.25) < 4 * np.sqrt(0.25 * 0.75 / len(pos))
    negs_u, negs = (u, other.astype(np.int64)) if name == "fism_bpr" else (u[~pos], item[~pos])
    assert tm._is_member(u[pos], item[pos]).all() and not tm._is_member(negs_u, negs).any()
    np.testing.assert_array_equal(basket, np.where(bmask > 0, hist, -1))
    # the masked history slots hold one item of the history: the target
    masked = np.where((hist >= 0) & (bmask == 0), hist, -1)
    target = masked.max(1)
    assert (target >= 0).all() and ((masked == -1) | (masked == target[:, None])).all()
    np.testing.assert_array_equal(target[pos], item[pos])
    assert _chi2_of_uniform_index(*_non_member_index(tm, negs_u, negs)) < 20


@pytest.mark.parametrize("name", list(SPEC))
def test_device_dispatches_are_finite_and_repeatable(mf_dataset, name):
    runs = []
    for _ in range(2):
        _, tm = _pair(name, mf_dataset)
        tm.samples_per_step, tm.chunks_per_dispatch = 64, 2
        start = tm.params_to_numpy()
        costs = []
        for it in range(2):
            cost, n = tm.training_step(it * 128)
            assert n == 128 and cost.dim() == 0
            costs.append(float(cost))
        assert np.isfinite(costs).all()
        tables = tm.params_to_numpy()
        assert all(np.isfinite(v).all() for v in tables.values())
        assert max(np.abs(tables[p] - start[p]).max() for p in ("V", "H", "V_user_item") if p in start) > 1e-4
        runs.append((costs, tables))
    assert runs[0][0] == runs[1][0]
    for p in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][p], runs[1][1][p])


def _instances(model, empty=False):
    out = [(s[: len(s) // 2], u) for s, u in model.dataset.validation_set(epochs=1) if len(s) >= 2]
    return out + ([([], 3)] if empty else [])


def _scores(model, instances):
    user_ids = np.array([int(u) for _, u in instances], dtype=np.int64)
    scores = model._batch_scores(user_ids, [s for s, _ in instances])
    for row, (seq, _) in zip(scores, instances):
        row[[int(i[0]) for i in seq]] = -np.inf
    return scores


def _assert_same_topk(got, want, scores, gap=1e-5):
    """Equal lists where the scores of neighbours in the list and of the
    k-th and (k+1)-th items differ by more than ``gap`` (relative to the
    row's largest); the same scores everywhere."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    k = got.shape[1]
    for r, row in enumerate(scores):
        np.testing.assert_allclose(row[got[r]], row[want[r]], rtol=1e-5, atol=1e-6)
        ordered = np.sort(row[np.isfinite(row)])[::-1][: k + 1]
        tol = gap * max(1.0, np.abs(ordered).max())
        if np.all(np.abs(np.diff(ordered)) > tol):
            np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("name", ONE_EACH)
def test_top_k_batch_matches_jax_by_both_routes(mf_dataset, name):
    jm, tm = _pair(name, mf_dataset)
    tm.samples_per_step, tm.chunks_per_dispatch = 64, 2
    tm.training_step(0)
    _share(jm, tm)
    instances = _instances(tm, empty=name in ("fism_bpr", "fossil"))
    scores = _scores(tm, instances)
    host = tm.top_k_batch(instances, k=10)
    np.testing.assert_array_equal(host, np.asarray(jm.top_k_batch(instances, k=10)))
    single = [tm.top_k_recommendations(s, user_id=int(u), k=10) for s, u in instances]
    np.testing.assert_array_equal(np.sort(single, 1), np.sort(host, 1))

    jm.DEVICE_TOPK_MIN_ITEMS = tm.DEVICE_TOPK_MIN_ITEMS = 1
    device = tm.top_k_batch(instances, k=10)
    _assert_same_topk(device, jm.top_k_batch(instances, k=10), scores)
    _assert_same_topk(device, host, scores)
    tm._DEVICE_TOPK_ROW_CHUNK = 7  # ragged row chunks give the same lists
    np.testing.assert_array_equal(tm.top_k_batch(instances, k=10), device)


@pytest.mark.parametrize("name", ONE_EACH)
def test_device_route_ranks_the_whole_catalog_past_k4(tmp_path_factory, name, monkeypatch):
    """``--save_rank`` asks the device route for k = n_items (90 here),
    past K4's k <= 64: the port sorts its masked device scores and gives the JAX
    package's full ranks (the same scores, and the same lists where no two
    scores tie within 1e-5); K4 is never called above 64 (on the card its
    wrapper refuses such a k)."""
    d = make_dataset(str(tmp_path_factory.mktemp("mf90")), n_users=40, n_items=90, min_len=5, max_len=20, seed=4)
    jm, tm = _pair(name, d)
    assert tm.n_items > 64
    tm.samples_per_step, tm.chunks_per_dispatch = 64, 2
    tm.training_step(0)
    _share(jm, tm)
    instances = _instances(tm, empty=name in ("fism_bpr", "fossil"))
    scores = _scores(tm, instances)
    calls = []

    def guarded(*args, **kwargs):
        k = kwargs["k"] if "k" in kwargs else args[5]
        assert 1 <= k <= 64, f"K4 called with k = {k}"
        calls.append(k)
        return k4(*args, **kwargs)

    k4 = tf.fused_score_topk
    monkeypatch.setattr(tf, "fused_score_topk", guarded)
    jm.DEVICE_TOPK_MIN_ITEMS = tm.DEVICE_TOPK_MIN_ITEMS = 1
    full = tm.top_k_batch(instances, k=tm.n_items)
    assert not calls and full.shape == (len(instances), tm.n_items)
    assert all(sorted(row) == list(range(tm.n_items)) for row in full.tolist())
    _assert_same_topk(full, jm.top_k_batch(instances, k=tm.n_items), scores)
    tm.top_k_batch(instances, k=10)
    assert calls == [10]


def test_empty_bags_score_finite(mf_dataset):
    for name in ("fism_bpr", "fossil"):
        _, tm = _pair(name, mf_dataset)
        scores = tm._batch_scores(np.array([0, 1], dtype=np.int64), [[], [(3, 1.0)]])
        assert np.isfinite(scores).all(), name
        single = tm.item_score(0, []) if name == "fossil" else tm.item_score([])
        assert np.isfinite(single).all(), name
        tm.DEVICE_TOPK_MIN_ITEMS = 1
        top = tm.top_k_batch([([], 0), ([(3, 1.0)], 1)], k=10)
        assert ((top >= 0) & (top < tm.n_items)).all() and 3 not in top[1]


def test_host_copies_follow_in_place_updates(mf_dataset):
    """The tables change in place, so the host copy is keyed on the tensor's
    version: a validation after a training step scores the new tables."""
    _, tm = _pair("bprmf", mf_dataset)
    tm.samples_per_step, tm.chunks_per_dispatch = 64, 2
    before = tm._np("V")
    assert tm._np("V") is before  # cached while unchanged
    metrics0 = tm._compute_validation_metrics({m: [] for m in tm.metrics})
    tm.training_step(0)
    after = tm._np("V")
    np.testing.assert_array_equal(after, tm.V.numpy())
    assert np.abs(after - before).max() > 1e-3
    fresh = tf.BPRMF(**SPEC["bprmf"][1], device="cpu")
    fresh.prepare_model(tm.dataset)
    fresh.params_from_numpy(tm.params_to_numpy())
    instances = _instances(tm)
    np.testing.assert_array_equal(tm.top_k_batch(instances), fresh.top_k_batch(instances))
    metrics = tm._compute_validation_metrics({m: [] for m in tm.metrics})
    assert metrics == fresh._compute_validation_metrics({m: [] for m in tm.metrics})
    assert metrics != metrics0


@pytest.mark.parametrize("view", ["writable", "jax_buffer"])
def test_params_from_numpy_copies_its_input(mf_dataset, view):
    """Training updates the tables in place; the arrays they were set from
    stay as they were, a read-only view of a JAX array's buffer too."""
    jm, tm = _pair("fossil", mf_dataset)
    given = {name: np.asarray(getattr(jm, name)) for name in tm._PARAMS}
    if view == "writable":
        given = {name: a.copy() for name, a in given.items()}
    kept = {name: a.copy() for name, a in given.items()}
    tm.params_from_numpy(given)
    tm.samples_per_step, tm.chunks_per_dispatch = 64, 1
    tm.training_step(0)
    for name in tm._PARAMS:
        np.testing.assert_array_equal(given[name], kept[name], err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)), kept[name], err_msg=name)
    assert np.abs(tm._np("V") - kept["V"]).max() > 1e-4


@pytest.mark.parametrize("name", list(SPEC))
def test_checkpoints_load_in_the_other_package(mf_dataset, tmp_path, name):
    jm, tm = _pair(name, mf_dataset)
    tm.samples_per_step, tm.chunks_per_dispatch = 64, 1
    tm.training_step(0)
    assert tm._get_model_filename(1.5) == jm._get_model_filename(1.5)
    path = str(tmp_path / ("port_" + tm._get_model_filename(1.5)))
    tm.save(path)
    with np.load(path) as f:
        assert list(f.keys()) == list(tm._PARAMS)
    jm.load(path)
    _assert_same_tables(jm, tm, rtol=0, atol=0)
    jm2, tm2 = _pair(name, mf_dataset, seed=9)
    path = str(tmp_path / ("jax_" + jm2._get_model_filename(2)))
    jm2.save(path)
    tm2.load(path)
    _assert_same_tables(jm2, tm2, rtol=0, atol=0)


@pytest.mark.parametrize(
    "argv",
    [["-m", "BPRMF", "-H", "32", "-l", "0.1", "-r", "0.0025", "--no_adaptive_sampling"],
     ["-m", "BPRMF", "-H", "16", "--fpmc_bias", "50", "--cooling", "0.9", "--init_sigma", "0.1"],
     ["-m", "FPMC", "--k_cf", "32", "--k_mc", "16", "-l", "0.1", "--no_adaptive_sampling"],
     ["-m", "FISM", "-H", "32", "-l", "0.01", "-r", "0.0025", "--init_sigma", "0.1", "--loss", "RMSE",
      "--fism_alpha", "0.2"],
     ["-m", "Fossil", "-H", "32", "-l", "0.05", "--fossil_order", "2", "--fism_alpha", "0.3"]],
)
def test_predictor_matches_jax(argv):
    jax_model = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert type(model).__name__ == type(jax_model).__name__
    assert model._get_model_filename(3) == jax_model._get_model_filename(3)
    for attr in ("k", "k_cf", "k_mc", "reg", "learning_rate", "annealing_rate", "init_sigma", "adaptive_sampling",
                 "sampling_bias", "loss", "alpha", "order", "samples_per_step", "chunks_per_dispatch",
                 "sub_chunks", "DEVICE_TOPK_MIN_ITEMS"):
        assert getattr(model, attr, None) == getattr(jax_model, attr, None), attr


def test_mf_cli_without_device_cpu_raises_when_no_gpu(mf_dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train_cli.main(["-d", mf_dataset, "-m", "BPRMF", "-H", "8", "--max_iter", "1"])


def _score_lines(text):
    return [line for line in text.splitlines() if "@10:" in line or "results on" in line]


@pytest.mark.parametrize(
    "flags",
    [["-m", "BPRMF", "-H", "8", "-l", "0.1", "--no_adaptive_sampling"],
     ["-m", "FPMC", "--k_cf", "8", "--k_mc", "8", "-l", "0.1", "--fpmc_bias", "10"],
     ["-m", "FISM", "-H", "8", "-l", "0.05", "--loss", "BPR", "--init_sigma", "0.1"],
     ["-m", "Fossil", "-H", "8", "-l", "0.05", "--init_sigma", "0.1", "--fossil_order", "2"]],
    ids=["bprmf", "fpmc", "fism", "fossil"],
)
def test_train_cli_checkpoints_score_alike_in_both_test_clis(mf_dataset, capsys, flags):
    """The port's train CLI (two dispatches, a validation after each), then
    both packages' test CLIs on its checkpoints: the same printed lines.
    For BPRMF also the JAX package's train CLI: the same file names, and
    again the same lines from both test CLIs."""
    base = ["-d", mf_dataset, *flags]
    name = flags[1].lower()
    train = ["--max_iter", "16384", "--progress", "8192", "--save", "All", "--extended_set"]
    torch_train_cli.main(base + train + ["--dir", name + "_port/", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if ln.startswith("sps :")]) == 2
    runs = [name + "_port/"]
    if name == "bprmf":
        jax_train_cli.main(base + train + ["--dir", name + "_jax/"])
        capsys.readouterr()
        runs.append(name + "_jax/")
        names = [sorted(os.listdir(os.path.join(mf_dataset, "models", d))) for d in runs]
        assert names[0] == names[1] and len(names[0]) == 2
    for run in runs:
        jax_test_cli.main(base + ["--dir", run])
        want = _score_lines(capsys.readouterr().out)
        torch_test_cli.main(base + ["--dir", run, "--device", "cpu"])
        got = _score_lines(capsys.readouterr().out)
        assert len(want) == 12 and got == want
