"""The port's CUDA kernels on the card, against their plain versions:
K1 (the bilinear pass) and K2 (its grid form over a coefficient bank),
with the spill remainder folded in (bitwise the pass without it followed
by ``spill_ordered``), both on the cells of a 2 x 2 mesh of spawned ranks,
and K4 (the per-entity products and the row kernel's member-wise dots and
norms, bitwise their ``row_sum`` forms).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-5 of the output's largest magnitude plus atol 1e-6,
and for the passes over the heavy column (K1's and K2's checks against
their plain versions) 1e-5 of each output's addends' magnitude. The
kernel sums in a fixed order of its own (a tree over each trip's runs,
then the shared blocks' rows in a fixed order), which differs from the
plain version's entry order and depends on the card's CTA target; it is
the same on every launch, so two launches agree bitwise. K2's checks bound each
element by rtol 1e-5 of its own sum of absolute terms (the same pass over
|vals| and |src|) plus atol 1e-6: a heavy column sums tens of thousands of
products, and the rounding of another order grows with that sum, not with
the output's largest element.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledGLMObjective,
    TileParams,
    build_tiled_batch,
)
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from photon_ml_tpu_torch.tools.kernel_cases import (
    edge_case_batches,
    nan_at_window_start,
    nan_source,
    real_entries_pass,
    schedule_without_block,
)

CASES = {
    "spills": (TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 700, 900),
    "no_spills": (TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=0), 700, 900),
    "ads_window": (TileParams(), 20000, 30000),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _close(got, expected):
    """Within 1e-6 + 1e-5 of the largest finite magnitude, with NaN in the
    same places."""
    g, e = got.cpu().numpy(), expected.cpu().numpy()
    nan = np.isnan(e)
    assert np.array_equal(np.isnan(g), nan)
    scale = float(np.abs(e[~nan]).max()) if (~nan).any() else 0.0
    np.testing.assert_allclose(g[~nan], e[~nan], rtol=0.0, atol=1e-6 + 1e-5 * scale)


def _batch(name, device):
    params, n, d = CASES[name]
    rng = np.random.default_rng(3)
    nnz = 12 * n
    rows = rng.integers(0, n, nnz)
    feats = rng.integers(0, d, nnz)
    feats[: nnz // 10] = d - 1  # a heavy column: ragged, long tiles
    vals = rng.normal(size=nnz).astype(np.float32)
    labels = (rng.uniform(size=n) > 0.5).astype(np.float32)
    tb = build_tiled_batch(
        rows, feats, vals, labels, np.zeros(n, np.float32),
        np.ones(n, np.float32), d, params=params, device=device,
    )
    return rng, tb, d


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_bilinear_pass_matches_plain(cuda, name):
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device=cuda)
    for sched, src, n_out, vals in (
        (tb.z_sched, w, tb.num_row_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, tb.g_vals_sq),
    ):
        before = k1.launches
        got = k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        # each output within 1e-5 of its addends' magnitude: the heavy
        # column sums a tenth of the entries, whose rounding in another
        # order grows with that sum (K2's checks hold it so too)
        abs_vals = (sched.vals if vals is None else vals).abs()
        abs_sum = k1.bilinear_pass_plain(sched, src.abs(), n_out, win, vals=abs_vals)
        _close_per_term(got, k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals), abs_sum)


@pytest.mark.cuda
def test_objective_on_card_matches_cpu(cuda):
    rng, tb, d = _batch("spills", cuda)
    obj = TiledGLMObjective(losses.LOGISTIC, d)
    w = rng.normal(scale=0.1, size=d).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    cpu_tb = tb.to("cpu")
    for method, args in (
        ("value_and_gradient", (w,)),
        ("hessian_vector", (w, v)),
        ("hessian_diagonal", (w,)),
    ):
        on_card = getattr(obj, method)(
            *(torch.as_tensor(a, device=cuda) for a in args), tb, 0.5
        )
        on_cpu = getattr(obj, method)(*(torch.as_tensor(a) for a in args), cpu_tb, 0.5)
        for x, y in zip(
            on_card if isinstance(on_card, tuple) else (on_card,),
            on_cpu if isinstance(on_cpu, tuple) else (on_cpu,),
        ):
            _close(x, y)


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands(cuda):
    _, tb, _ = _batch("spills", cuda)
    win = tb.params.window
    with pytest.raises(TypeError):
        k1.bilinear_pass(
            tb.z_sched, torch.zeros(tb.dim, dtype=torch.float64, device=cuda),
            tb.num_row_blocks, win,
        )
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim + 1, device=cuda),
                         tb.num_row_blocks, win)
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim - win, device=cuda),
                         tb.num_row_blocks, win)
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim, device=cuda),
                         tb.num_row_blocks - 1, win)


def _close_per_term(got, expected, abs_sum):
    """|got - expected| <= 1e-6 + 1e-5 * abs_sum, elementwise."""
    err = (got - expected).abs().cpu().numpy()
    bound = 1e-6 + 1e-5 * abs_sum.cpu().numpy()
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert np.all(err <= bound), (worst, err[worst], bound[worst])


def _passes(tb, w, c):
    """(schedule, source, output blocks, values) of the z, g and g_sq
    passes."""
    return (
        (tb.z_sched, w, tb.num_row_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, tb.g_vals_sq),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3, 4, 5, 7, 9])
@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_pass_matches_plain_and_k1(cuda, name, G):
    """K2 against its plain version and against G launches of K1, on all
    three passes (7 members: one full tile at the default window; 9: two
    tiles)."""
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device=cuda)
    for sched, src, n_out, vals in _passes(tb, w, c):
        before = k2.launches
        got = k2.grid_bilinear_pass(sched, src, n_out, win, vals=vals)
        torch.cuda.synchronize()
        assert k2.launches == before + 1
        assert got.shape == (G, n_out * win)
        abs_vals = (sched.vals if vals is None else vals).abs()
        abs_sum = k2.grid_bilinear_pass_plain(sched, src.abs(), n_out, win, vals=abs_vals)
        plain = k2.grid_bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        _close_per_term(got, plain, abs_sum)
        per_member = torch.stack([
            k1.bilinear_pass(sched, src[g], n_out, win, vals=vals) for g in range(G)
        ])
        _close_per_term(got, per_member, abs_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_passes_repeat_bitwise(cuda, name):
    """K1 (z, g and squared g) and K2 over a bank of 4, each with its
    spill remainder folded in (on a vector and on the bank): two launches
    on the same operands give the same bits, and the fold agrees with
    ``index_add_`` of the spilled products."""
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=(4, tb.dim)).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=(4, tb.num_rows)).astype(np.float32), device=cuda)
    for sched, src, n_out, vals in _passes(tb, w, c):
        spill_vals = None if vals is None else sched.spill_vals ** 2
        for run, x in ((k1.bilinear_pass, src[0]), (k2.grid_bilinear_pass, src)):
            first = run(sched, x, n_out, win, vals=vals, spill=True, spill_vals=spill_vals)
            again = run(sched, x, n_out, win, vals=vals, spill=True, spill_vals=spill_vals)
            assert torch.equal(first, again)
            unfused = run(sched, x, n_out, win, vals=vals)
            sv = sched.spill_vals if spill_vals is None else spill_vals
            plain = unfused.clone().index_add_(
                -1, sched.spill_out, sv * x.index_select(-1, sched.spill_in))
            _close(first, plain)


def _sole_and_shared(sched, cfg):
    """(blocks one item writes alone, blocks several items share) of a
    launch's plan that hold a spilled slot."""
    plan, _ = k1.spill_operands(sched)
    spilled = set((plan.slots.cpu().numpy() // sched.window).tolist())
    items = cfg.plan.items.cpu().numpy()
    sole = {int(b) for b in items[items[:, 6] < 0, 0]} & spilled
    shared = {int(b) for b in cfg.plan.shared.cpu().numpy()[:, 0]} & spilled
    return sole, shared


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spills", "ads_window"])
def test_fused_passes_bitwise_unfused_then_spill_ordered(cuda, name):
    """K1 (z, g and squared g; source windows staged and gathered) and K2
    (G = 1, 3, 4, 5) with the spill folded in are bitwise the same launch
    without it followed by ``spill_ordered``, the plain form of the fold;
    each launch also on a plan for 4 CTAs, whose blocks an item writes
    alone, beside the card's plan, whose blocks several items share, so
    both places the kernels add the spill are met."""
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    met = {"sole": 0, "shared": 0}
    for G in (None, 1, 3, 4, 5):
        shape = () if G is None else (G,)
        w = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device=cuda)
        c = torch.as_tensor(rng.normal(size=shape + (tb.num_rows,)).astype(np.float32), device=cuda)
        for sched, src, n_out, vals in _passes(tb, w, c):
            v = sched.vals if vals is None else vals
            spill = k1.spill_operands(sched, None if vals is None else sched.spill_vals ** 2)
            if G is None:
                cfg = k1.launch_config(sched, v, cuda)
                cfgs = [dataclasses.replace(cfg, mode=mode) for mode in (k1.STAGED, k1.GATHERED)]
                launch = k1.launch_with
            else:
                cfgs = [k2.launch_config(sched, v, cuda, G)]
                launch = k2.launch_with
            cfgs += [dataclasses.replace(cfg, plan=k1.make_plan(sched, 4)) for cfg in cfgs]
            for cfg in cfgs:
                fused = launch(cfg, sched, src, n_out, win, v, spill)
                unfused = launch(cfg, sched, src, n_out, win, v)
                torch.cuda.synchronize()
                assert torch.equal(fused, k1.spill_ordered(unfused, src, *spill))
                sole, shared = _sole_and_shared(sched, cfg)
                met["sole"] += len(sole)
                met["shared"] += len(shared)
    assert met["sole"] and met["shared"], met


ROW_SHAPES = [(2, 1 << 20), (4, 1 << 20), (25_000, 16), (25_000, 437)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ROW_SHAPES + ["strided"], ids=str)
def test_row_kernel_gives_row_sums_bits_in_one_launch(cuda, dtype, shape):
    """``row_dot`` (a dot and a sum), ``row_norm`` and ``row_dots`` (three
    pairs) are bitwise their ordered forms (``row_sum`` of the products on
    the CPU; the norm its sqrt), one launch a call at any row length; a
    strided view takes the kernel's one-element loads."""
    from photon_ml_tpu_torch.ops.kernels import entity_products as ep

    ep.build_kernel()
    rng = np.random.default_rng(17)
    n, k = (6, 20_000) if shape == "strided" else shape
    a, b, e = (torch.as_tensor(rng.normal(size=(n, k)), dtype=dtype) for _ in range(3))
    ad, bd, ed = (t.to(cuda) for t in (a, b, e))
    if shape == "strided":
        ad, bd = (torch.stack([t, t], -1).reshape(n, 2 * k)[:, ::2] for t in (ad, bd))
        assert ep.row_vector(k, [ad, bd]) == 1
    ep.reset_launches()
    got = {
        "dot": ep.row_dot(ad, bd), "sum": ep.row_dot(ad), "norm": ep.row_norm(ad),
        "dots": ep.row_dots([(ad, bd), (bd, ed), (ad, ad)]),
    }
    torch.cuda.synchronize()
    assert ep.launches == ep.launches_by["row_dot"] == 4
    assert torch.equal(got["dot"].cpu(), ep.row_dot_ordered(a, b))
    assert torch.equal(got["sum"].cpu(), ep.row_dot_ordered(a))
    # sqrt, correctly rounded on the card as in numpy
    assert torch.equal(got["norm"].cpu(), torch.as_tensor(np.sqrt(ep.row_dot_ordered(a, a).numpy())))
    assert torch.equal(got["norm"], torch.sqrt(ep.row_dot_ordered(ad, ad)))
    want = torch.stack([ep.row_dot_ordered(a, b), ep.row_dot_ordered(b, e),
                        ep.row_dot_ordered(a, a)])
    assert torch.equal(got["dots"].cpu(), want)
    again = ep.row_dot(ad, bd)  # the tickets reset themselves
    assert torch.equal(again, got["dot"])


@pytest.mark.cuda
def test_fixed_order_index_add_repeats_bitwise(cuda):
    """The scatter objective's fixed-order add: a heavy index (a third of
    the sources on one output) gives the same bits twice, and each output
    is within 1e-5 of its addends' magnitude of a float64 ``index_add_``
    (the float32 one's atomics round the heavy sum differently each run)."""
    from photon_ml_tpu_torch.ops import fixed_order

    rng = np.random.default_rng(2)
    index = torch.as_tensor(rng.integers(0, 5000, 300000), device=cuda)
    index[:100000] = 7
    src = torch.as_tensor(rng.normal(size=(3, 300000)).astype(np.float32), device=cuda)
    runs = [
        fixed_order.index_add(torch.zeros(3, 5000, device=cuda), index, src)
        for _ in range(2)
    ]
    assert torch.equal(runs[0], runs[1])
    exact = torch.zeros(3, 5000, device=cuda, dtype=torch.float64).index_add_(
        -1, index, src.double())
    magnitude = torch.zeros(3, 5000, device=cuda, dtype=torch.float64).index_add_(
        -1, index, src.double().abs())
    _close_per_term(runs[0].double(), exact, magnitude)


EDGE_CASES = ["split_steps", "one_step_block", "odd_chunk", "heavy_row"]


def _edge_batch(name, device):
    return dict(edge_case_batches(device))[name]


@pytest.mark.cuda
@pytest.mark.parametrize("nan", ["none", "entry", "window_start"])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_cases_match_plain(cuda, name, nan):
    """K1 and K2 (G in 1, 3, 4, 5, 7, 9) on the work plan's edge cases:
    against their plain versions with a finite source and with a NaN where
    a nonzero entry reads it; with a NaN at the first slot of a window
    that a padded step reads, against the pass over the real entries (the
    plain version's padding slots carry that NaN into slot 0 of their
    output block; the kernels skip padding, so theirs do not)."""
    tb = _edge_batch(name, cuda)
    win = tb.params.window
    rng = np.random.default_rng(1)
    for G in (None, 1, 3, 4, 5, 7, 9):
        shape = () if G is None else (G,)
        w = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device=cuda)
        c = torch.as_tensor(rng.normal(size=shape + (tb.num_rows,)).astype(np.float32), device=cuda)
        for sched, src, n_out, vals in _passes(tb, w, c):
            plain_of = k1.bilinear_pass_plain if G is None else k2.grid_bilinear_pass_plain
            if nan == "window_start":
                src, plain, expected = nan_at_window_start(sched, src, n_out, win, vals)
                assert int(torch.isnan(plain).sum()) > int(torch.isnan(expected).sum())
            else:
                if nan == "entry":
                    src = nan_source(sched, src)
                expected = plain_of(sched, src, n_out, win, vals=vals)
            kernel = k1.bilinear_pass if G is None else k2.grid_bilinear_pass
            got = kernel(sched, src, n_out, win, vals=vals)
            torch.cuda.synchronize()
            if nan != "none":
                assert bool(torch.isnan(expected).any())
            _close(got, expected)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [0, 3])
def test_output_block_without_steps_is_zero(cuda, block):
    """An output block without any step: the kernels write its window as
    zeros into an output whose memory held NaN just before."""
    tb = _edge_batch("one_step_block", cuda)
    sched = schedule_without_block(tb.z_sched, block)
    win, n_out = tb.params.window, tb.num_row_blocks
    rng = np.random.default_rng(2)
    for G in (None, 1, 4, 9):
        shape = () if G is None else (G,)
        src = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device=cuda)
        torch.full(shape + (n_out * win,), float("nan"), device=cuda)  # freed
        if G is None:
            got = k1.bilinear_pass(sched, src, n_out, win)
        else:
            got = k2.grid_bilinear_pass(sched, src, n_out, win)
        torch.cuda.synchronize()
        assert not bool(got[..., block * win : (block + 1) * win].any())
        _close(got, real_entries_pass(sched, src, n_out, win))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ads_window", "spills"])
def test_both_window_modes_match_plain(cuda, name):
    """K1 with the source windows staged in shared memory and read
    through L1 (the schedule's gather order picks one per pass; both are
    on the path) computes the plain version's pass on every pass, held per
    term as above: the heavy column sums ~24,000 products."""
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device=cuda)
    for sched, src, n_out, vals in _passes(tb, w, c):
        v = sched.vals if vals is None else vals
        plain = k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        abs_sum = k1.bilinear_pass_plain(sched, src.abs(), n_out, win, vals=v.abs())
        cfg = k1.launch_config(sched, v, cuda)
        for mode in (k1.STAGED, k1.GATHERED):
            got = k1.launch_with(dataclasses.replace(cfg, mode=mode), sched, src, n_out, win, v)
            _close_per_term(got, plain, abs_sum)


@pytest.mark.cuda
def test_bank_objective_on_card_matches_cpu(cuda):
    """The tiled objective over a bank on the card (K2) against the same
    on the CPU (the plain grid pass), with per-member l2."""
    rng, tb, d = _batch("spills", cuda)
    obj = TiledGLMObjective(losses.LOGISTIC, d)
    G = 3
    w = rng.normal(scale=0.1, size=(G, d)).astype(np.float32)
    v = rng.normal(size=(G, d)).astype(np.float32)
    l2 = np.array([0.0, 0.5, 2.0], np.float32)
    cpu_tb = tb.to("cpu")
    for method, args in (
        ("value_and_gradient", (w,)),
        ("hessian_vector", (w, v)),
        ("hessian_diagonal", (w,)),
    ):
        before = (k1.launches, k2.launches)
        on_card = getattr(obj, method)(
            *(torch.as_tensor(a, device=cuda) for a in args), tb,
            torch.as_tensor(l2, device=cuda),
        )
        torch.cuda.synchronize()
        assert k1.launches == before[0] and k2.launches > before[1]
        on_cpu = getattr(obj, method)(
            *(torch.as_tensor(a) for a in args), cpu_tb, torch.as_tensor(l2)
        )
        for x, y in zip(
            on_card if isinstance(on_card, tuple) else (on_card,),
            on_cpu if isinstance(on_cpu, tuple) else (on_cpu,),
        ):
            _close(x, y)


@pytest.mark.cuda
def test_grid_wrapper_rejects_bad_operands(cuda):
    _, tb, _ = _batch("spills", cuda)
    win = tb.params.window
    ok = torch.zeros(2, tb.dim, device=cuda)
    with pytest.raises(TypeError):
        k2.grid_bilinear_pass(tb.z_sched, ok.double(), tb.num_row_blocks, win)
    with pytest.raises(ValueError):
        k2.grid_bilinear_pass(tb.z_sched, ok[:, :-1], tb.num_row_blocks, win)
    with pytest.raises(ValueError):  # not contiguous
        k2.grid_bilinear_pass(
            tb.z_sched, torch.zeros(tb.dim, 2, device=cuda).T, tb.num_row_blocks, win
        )
    with pytest.raises(ValueError):
        k2.grid_bilinear_pass(tb.z_sched, ok, tb.num_row_blocks - 1, win)


def _mesh_fit_rank(mesh):
    """Feature-sharded L-BFGS and its batched grid, each with variances,
    on this rank's cell; -> values, iterations and K1 / K2 launches."""
    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
    from photon_ml_tpu_torch.optim.config import RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import (
        train_feature_sharded,
        train_grid_batched_feature_sharded,
    )

    rng = np.random.default_rng(5)
    n, d, k = 4000, 30000, 8
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    labels = (rng.uniform(size=n) > 0.5).astype(np.float32)
    batch = sparse_batch_from_arrays(
        idx, vals, labels, np.zeros(n, np.float32), np.ones(n, np.float32),
        device="cpu",
    )
    kw = dict(
        regularization_type=RegularizationType.L2, max_iter=8,
        compute_variances=True, kernel="tiled",
    )
    out = {}
    for name, trainer, weights in (
        ("k1", train_feature_sharded, [1.0, 0.1]),
        ("k2", train_grid_batched_feature_sharded, [1.0, 0.1, 0.01]),
    ):
        k1.launches = k2.launches = 0
        models, results = trainer(
            batch, TaskType.LOGISTIC_REGRESSION, d, mesh=mesh,
            regularization_weights=weights, **kw,
        )
        out[name] = dict(
            launches=(k1.launches, k2.launches),
            fits={lam: (float(r.value), r.iterations) for lam, r in results.items()},
        )
    return out


@pytest.mark.cuda
def test_feature_sharded_fits_on_card_match_cpu(cuda):
    """Every rank of a 2 x 2 mesh on the card launches K1 for the
    sequential fits and K2 for the grid, never the other, and lands where
    the same mesh on the CPU (the plain passes) does: the same iterations,
    values within rtol 1e-5."""
    k1.build_kernel()
    k2.build_kernel()
    axes = (DATA_AXIS, MODEL_AXIS)
    card = spawn_mesh(_mesh_fit_rank, (2, 2), axes, timeout_s=600.0)
    cpu = spawn_mesh(_mesh_fit_rank, (2, 2), axes, device="cpu", timeout_s=600.0)
    for rank in card:
        assert rank["k1"]["launches"][0] > 0 and rank["k1"]["launches"][1] == 0
        assert rank["k2"]["launches"][0] == 0 and rank["k2"]["launches"][1] > 0
        for name in ("k1", "k2"):
            for lam, (value, iterations) in rank[name]["fits"].items():
                want_value, want_iterations = cpu[0][name]["fits"][lam]
                assert iterations == want_iterations
                np.testing.assert_allclose(value, want_value, rtol=1e-5)


# ---------------------------------------------------------------------------
# K4, the per-entity products in row_sum's order
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_entity_products_give_row_sums_bits(cuda, dtype):
    """K4's Gram, matvecs (X, X^T as a view, G) and row dots are bitwise
    their ``*_ordered`` forms (row_sum of the products, on the CPU), and
    within rounding of the plain versions; every launch plan (a warp or
    less, a CTA, partial launches of a long row) at once."""
    from photon_ml_tpu_torch.ops.kernels import entity_products as ep

    ep.build_kernel()
    rng = np.random.default_rng(11)
    X = torch.as_tensor(rng.normal(size=(37, 19, 45)), dtype=dtype)
    c = torch.as_tensor(rng.normal(size=(37, 45)), dtype=dtype)
    r = torch.as_tensor(rng.normal(size=(37, 19)), dtype=dtype)
    Xd, cd, rd = X.to(cuda), c.to(cuda), r.to(cuda)
    G = ep.gram(Xd)
    assert torch.equal(G.cpu(), ep.gram_ordered(X))
    assert torch.equal(ep.bmv(Xd, cd).cpu(), ep.bmv_ordered(X, c))
    assert torch.equal(ep.bmv(Xd.transpose(1, 2), rd).cpu(), ep.bmv_ordered(X.transpose(1, 2), r))
    assert torch.equal(ep.bmv(G, rd).cpu(), ep.bmv_ordered(ep.gram_ordered(X), r))
    torch.testing.assert_close(G, ep.gram_plain(Xd), rtol=1e-5, atol=1e-5)
    # the Gram kernel at run G's entity shape (f64: past 48 KB of shared
    # memory) and, past a warp's row, the general kernel
    for shape in ((8, 16, 437), (3, 5, 600)):
        Xs = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
        assert (ep.gram_plan(shape[1], shape[2], Xs.element_size()) is None) == (shape[2] > 512)
        assert torch.equal(ep.gram(Xs.to(cuda)).cpu(), ep.gram_ordered(Xs))
    for k in (1, 3, 32, 600, 20_000, 300_000):
        a = torch.as_tensor(rng.normal(size=(5, k)), dtype=dtype)
        b = torch.as_tensor(rng.normal(size=(5, k)), dtype=dtype)
        assert torch.equal(ep.row_dot(a.to(cuda), b.to(cuda)).cpu(), ep.row_dot_ordered(a, b))
        assert torch.equal(ep.row_dot(a.to(cuda)).cpu(), ep.row_dot_ordered(a))
    with pytest.raises(ValueError):
        ep.row_dot(Xd.to(torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["newton", "dense_lbfgs", "dense_tron", "sparse_lbfgs"])
def test_entity_solves_on_card_bitwise_in_any_block(cuda, case):
    """On the card, a bucket solved whole and as padded sub-blocks of other
    entity counts gives its shared entities the same rows, iterations and
    stop reasons, bit for bit (``tests/test_torch_entity_order.py`` holds
    the same on the CPU)."""
    import test_torch_entity_order as order

    from photon_ml_tpu_torch.ops.kernels import entity_products as ep

    kind, opt = order.SOLVES[case]
    problem = order._problem(opt)
    ix, v, lab, off, w = (t.to(cuda) for t in order._bucket(7, torch.float32))
    start = torch.zeros(order.E, order.D, device=cuda)
    ep.launches = 0
    rows, iters, reasons = problem._solve(kind, start, ix, v, lab, off, w, 0.0, 1.0)
    assert ep.launches > 0
    iters, reasons = order._as_list(iters), order._as_list(reasons)
    for pick, width in ((list(range(0, order.E, 2)), 23), (list(range(1, order.E, 3)), 14)):
        sub = [order._block(t, pick, width) for t in (start, ix, v, lab, off, w)]
        got, it, rs = problem._solve(kind, sub[0], *sub[1:], 0.0, 1.0)
        n = len(pick)
        assert torch.equal(got[:n], rows[pick])
        assert order._as_list(it)[:n] == [iters[p] for p in pick]
        assert order._as_list(rs)[:n] == [reasons[p] for p in pick]
