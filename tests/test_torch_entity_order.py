"""An entity's random-effect solve rounds the same at any batch size.

One bucket is solved whole, then its entities are solved again as padded
sub-blocks of other entity counts, the way the entity-sharded bank
(``game/pod.py``) builds a rank's blocks: a subset of the bucket's
entities in their order, zero-padded to the block's width. The shared
entities' rows, iteration counts and stop reasons must be bitwise equal,
for the dense Newton solver, dense L-BFGS, TRON and a sparse bucket.

On the CPU the solves run the products' plain versions (PyTorch's own
``bmm`` and sums); the card's kernel (``ops/kernels/entity_products.py``)
adds in ``data/batch.py`` ``row_sum``'s order, and the second half holds
its launch plans' trees to ``row_sum`` bit for bit, emulated here in plain
PyTorch: the general kernel's (the serial leaves of a thread, then the
group's halving, then the partial launches of a long row) and the row
kernel's (V positions a thread, the group's halving, a long row's CTAs'
partials merged by the tickets, the last widths inside the thread).
``chip_smoke.py`` holds the kernels themselves to the same bits on the
card.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.batch import row_sum
from photon_ml_tpu_torch.game import RandomEffectOptimizationProblem
from photon_ml_tpu_torch.ops.kernels import entity_products as ep
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

E, S, K, D = 40, 12, 4, 8

# (solver kind, optimizer); the kind is what _solve dispatches on
SOLVES = {
    "newton": ("newton", "LBFGS"),
    "dense_lbfgs": ("dense", "LBFGS"),
    "dense_tron": ("dense", "TRON"),
    "sparse_lbfgs": ("sparse", "LBFGS"),
    "sparse_tron": ("sparse", "TRON"),
}


def _bucket(seed, dtype):
    """A bucket's solve inputs [E, S, K] made with numpy: entity e has
    4 + e % 9 active rows, the rest padding (index 0, value 0, weight 0)."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, D, size=(E, S, K))
    v = rng.normal(size=(E, S, K))
    lab = (rng.uniform(size=(E, S)) < 0.5).astype(np.float64)
    off = rng.normal(size=(E, S)) * 0.3
    w = rng.uniform(0.5, 1.5, size=(E, S))
    rows = 4 + np.arange(E) % 9
    pad = np.arange(S)[None, :] >= rows[:, None]
    ix[pad], v[pad], w[pad], lab[pad], off[pad] = 0, 0.0, 0.0, 0.0, 0.0
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return torch.as_tensor(ix), t(v), t(lab), t(off), t(w)


def _problem(opt):
    return RandomEffectOptimizationProblem(
        LOGISTIC,
        OptimizerConfig(OptimizerType(opt), max_iter=50, tolerance=1e-6),
        RegularizationContext(RegularizationType.L2), reg_weight=1.0, layout="dense",
    )


def _as_list(x):
    return [int(a) for a in (x.tolist() if torch.is_tensor(x) else x)]


def _block(t, pick, width):
    """The entities ``pick`` of a bucket tensor, zero-padded to ``width``
    (the pod's block layout)."""
    out = t.new_zeros((width,) + tuple(t.shape[1:]))
    out[: len(pick)] = t[pick]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_sub_block_solves_bitwise_as_the_whole_bucket(case, dtype):
    kind, opt = SOLVES[case]  # a dense kind densifies the rows itself
    problem = _problem(opt)
    ix, v, lab, off, w = _bucket(7, dtype)
    start = torch.zeros(E, D, dtype=dtype)
    start[::3] = 0.1  # some warm rows
    rows, iters, reasons = problem._solve(kind, start, ix, v, lab, off, w, 0.0, 1.0)
    iters, reasons = _as_list(iters), _as_list(reasons)
    assert len(set(iters)) > 1, "a case whose entities all stop alike shows nothing"
    # sub-blocks as shard blocks of 2, 3 and 4 ranks would hold them
    for pick, width in ((list(range(0, E, 2)), 23), (list(range(1, E, 3)), 14),
                        (list(range(E - 1, -1, -4))[::-1], 17), ([5], 1)):
        sub = [_block(t, pick, width) for t in (start, ix, v, lab, off, w)]
        got, it, rs = problem._solve(kind, sub[0], *sub[1:], 0.0, 1.0)
        n = len(pick)
        assert torch.equal(got[:n], rows[pick]), f"{case}: rows differ in a block of {width}"
        assert _as_list(it)[:n] == [iters[p] for p in pick]
        assert _as_list(rs)[:n] == [reasons[p] for p in pick]


# ---------------------------------------------------------------------------
# the kernel's order, emulated
# ---------------------------------------------------------------------------


def _emulate(rows):
    """The kernel's launches over ``rows`` [n, k] as ``launch_plan`` gives
    them, in plain PyTorch: each thread q of an output's P sums its leaves
    q + P m (m < M) by halving its M slots, then either writes its partial
    (a partial launch: the next launch's row) or the P threads halve
    together (the shuffles and the shared-memory tree)."""
    n, k = rows.shape
    w = ep.padded_width(k)
    x = torch.nn.functional.pad(rows, (0, w - k))
    for p, m, partial in ep.launch_plan(k):
        assert p * m == x.shape[1]
        buf = x.view(n, m, p)  # buf[:, m, q] = x[:, q + p * m]
        h = m // 2
        while h >= 1:
            buf = buf[:, :h] + buf[:, h:2 * h]
            h //= 2
        x = buf[:, 0]
        if not partial:
            while x.shape[1] > 1:
                half = x.shape[1] // 2
                x = x[:, :half] + x[:, half:]
            return x[:, 0]
    raise AssertionError("a launch plan must end with a full launch")


def _halve(x, dim):
    """Halve dimension ``dim`` of ``x`` (a power of two) down to 1, slot
    m taking slot m + h: the tree's order over it."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _emulate_rows(a, b, mode, v, plan):
    """The row kernel over ``a`` (and ``b``) [n, k] as ``row_plan`` gives
    it, in plain PyTorch. A short row: thread u of its U owns positions v u
    + j + v U m and halves its M leaves of each j serially, then the
    halving across the threads. A long row: CTA c's lane l owns residues q
    = 32 v c + v l + j of P, warp w the leaves q + P (w + 8 s), halved over
    s by the thread, then over w across the warps; the CTAs' partials
    (items of 32 v) in groups of up to ROW_FANIN items g + (n / f) k,
    halved over k, level by level; then the halving across warp 0's lanes.
    Last, the log2(v) widths inside the thread."""
    m, lu, lc = plan
    n, k = a.shape
    x = a if mode == ep.SUM else a * (b if mode == ep.DOT else a)
    if lc:
        Q = 32 * v
        P = Q << lc
        assert 8 * P * m == ep.padded_width(k) and lu == 8
        x = torch.nn.functional.pad(x, (0, 8 * P * m - k))
        # position q + P i, leaf i = 8 s + w
        items = _halve(_halve(x.view(n, m, ep.ROW_WARPS, 1 << lc, Q), 1), 1)
        count = 1 << lc
        while count > 1:
            f = min(ep.ROW_FANIN, count)
            count //= f
            items = _halve(items.view(n, f, count, Q), 1)  # item g + count * k
        part = items.view(n, 32, v)
    else:
        U = 1 << lu
        assert v * U * m == ep.padded_width(k)
        x = torch.nn.functional.pad(x, (0, v * U * m - k))
        part = _halve(x.view(n, m, U, v), 1)  # [n, U, v]: S(v u + j, v U)
    out = _halve(_halve(part, 1), 1)
    return torch.sqrt(out) if mode == ep.NORM else out


ROW_LAYOUTS = ["tree_dot", "rows_f32", "rows_f64", "rows_strided", "rows_square"]


@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize(
    "k", [0, 1, 2, 3, 5, 8, 17, 32, 33, 100, 512, 513, 777, 4096, 16384, 16385, 40000, 300_000,
          1 << 20],
)
def test_launch_plans_follow_row_sums_tree(k, layout):
    """Each plan of ``k``: the general kernel's launches (``launch_plan``:
    bmv, the Gram past shared memory) and the row kernel's single launch
    (``row_plan``: row_dot in float32 and float64, a strided view read an
    element at a time, the norm's squares) give ``row_sum``'s bits."""
    rng = np.random.default_rng(k)
    n = 3 if k > 10_000 else 17
    dtype = np.float64 if layout == "rows_f64" else np.float32
    rows = torch.as_tensor(rng.normal(size=(n, k)).astype(dtype) * 10.0 ** rng.integers(
        -3, 4, size=(n, k)))
    if layout == "tree_dot":
        assert torch.equal(_emulate(rows), row_sum(rows))
        plan = ep.launch_plan(k)
        assert all((partial or p <= 1024) and (p & (p - 1)) == 0 and 1 <= m <= 16
                   for p, m, partial in plan)
        assert not plan[-1][2] and all(partial for _, _, partial in plan[:-1])
        return
    other = torch.as_tensor(rng.normal(size=(n, k)).astype(dtype))
    if layout == "rows_strided":
        rows = torch.as_tensor(np.repeat(rows.numpy(), 2, axis=1))[:, ::2]
    v = ep.row_vector(k, [rows, other])
    widest = 16 // rows.element_size()
    assert v == (1 if k == 0 or k % widest or layout == "rows_strided" else widest)
    plan = ep.row_plan(k, v)
    m, lu, lc = plan
    assert 1 <= m <= 16 and lu <= 8 and (lc == 0 or lu == 8)
    if layout == "rows_square":
        got, want = _emulate_rows(rows, None, ep.NORM, v, plan), torch.sqrt(row_sum(rows * rows))
    else:
        got, want = _emulate_rows(rows, other, ep.DOT, v, plan), row_sum(rows * other)
    assert torch.equal(got, want)
    if layout == "rows_f32":
        assert torch.equal(_emulate_rows(rows, None, ep.SUM, v, plan), row_sum(rows))


def test_ordered_forms_are_row_sums_of_the_products():
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.normal(size=(5, 7, 6)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(5, 6)).astype(np.float32))
    r = torch.as_tensor(rng.normal(size=(5, 7)).astype(np.float32))
    G = ep.gram_ordered(X)
    for e in range(5):
        for i in range(7):
            assert torch.equal(G[e, i], row_sum(X[e, i][None, :] * X[e]))
    assert torch.equal(ep.bmv_ordered(X, c), row_sum(X * c[:, None, :]))
    assert torch.equal(ep.bmv_ordered(X.transpose(1, 2), r),
                       row_sum(X.transpose(1, 2) * r[:, None, :]))
    assert torch.equal(ep.row_dot_ordered(c, c), row_sum(c * c))
    # and every form is the plain function within float32 rounding
    torch.testing.assert_close(G, ep.gram_plain(X), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ep.bmv_ordered(X, c), ep.bmv_plain(X, c), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_take_the_plain_versions():
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(4, 5, 3)))
    c = torch.as_tensor(rng.normal(size=(4, 3)))
    before = ep.launches
    assert torch.equal(ep.gram(X), ep.gram_plain(X))
    assert torch.equal(ep.bmv(X, c), ep.bmv_plain(X, c))
    assert torch.equal(ep.row_dot(c, c), ep.row_dot_plain(c, c))
    assert torch.equal(ep.row_dot(c), c.sum(dim=-1))
    assert torch.equal(ep.row_norm(c), torch.linalg.vector_norm(c, dim=-1))
    assert ep.launches == before
    with pytest.raises(ValueError):
        ep.bmv(X, c[:, :2])


def _emulated_kernel(src, src_b, dst, E, I, J, K, sa, sb, p, m, partial):
    """The kernel's C entry point in plain PyTorch on CPU tensors: the same
    operands (outputs E x I x J, row length K, four strides each), the
    thread's serial halving of its M leaves q + P m, then the group's
    halving, or the partials written out."""
    n = E * I * J
    a = src.as_strided((E, I, J, K), sa, src.storage_offset())
    x = a if src_b is None else a * src_b.as_strided((E, I, J, K), sb, src_b.storage_offset())
    x = torch.nn.functional.pad(x.reshape(n, K), (0, p * m - K))
    buf = x.view(n, m, p)
    h = m // 2
    while h >= 1:
        buf = buf[:, :h] + buf[:, h:2 * h]
        h //= 2
    v = buf[:, 0]
    if partial:
        dst.view(n, p).copy_(v)
        return
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    dst.copy_(v[:, 0])


def _emulated_rows_call(pairs, out, mode, v, plan):
    """The row kernel's C entry point in plain PyTorch on CPU tensors: each
    pair's rows read through their strides (a 16-byte load only where the
    kernel may take one), reduced by ``_emulate_rows`` into ``out``."""
    for i, (a, b) in enumerate(pairs):
        R, K = a.shape
        if v > 1:
            for t in (a,) if b is None else (a, b):
                assert t.stride(1) == 1 and t.stride(0) % v == 0 and K % v == 0
        read = [t.as_strided((R, K), t.stride(), t.storage_offset()) if t is not None else None
                for t in (a, b)]
        out[i] = _emulate_rows(*read, mode, v, plan)


def test_wrapper_operands_give_the_ordered_forms():
    """The operands each wrapper hands the kernel (its strides, output
    grid and the partial launches' chaining; the row kernel's pairs, V and
    plan), run through an emulation of the kernel, give the ``*_ordered``
    forms bit for bit: a transposed view, a Gram, and rows long enough for
    a long row's CTAs; one launch each."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.normal(size=(6, 9, 37)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(6, 37)).astype(np.float32))
    r = torch.as_tensor(rng.normal(size=(6, 9)).astype(np.float32))
    before, before_by = ep.launches, dict(ep.launches_by)

    def run(kind, a, b, args):
        return ep.run_plan(kind, _emulated_kernel, a, b, *args)

    G = run("gram", X, X, ep.gram_args(X)).reshape(6, 9, 9)
    assert torch.equal(G, ep.gram_ordered(X))
    assert torch.equal(run("bmv", X, c, ep.bmv_args(X, c)).reshape(6, 9), ep.bmv_ordered(X, c))
    Xt = X.transpose(1, 2)
    assert torch.equal(run("bmv", Xt, r, ep.bmv_args(Xt, r)).reshape(6, 37),
                       ep.bmv_ordered(Xt, r))
    def rows(pairs, mode):
        return ep.run_rows(_emulated_rows_call, pairs, mode)

    for k in (5, 700, 300_000):
        a = torch.as_tensor(rng.normal(size=(3, k)).astype(np.float32))
        b = torch.as_tensor(rng.normal(size=(3, k)).astype(np.float32))
        assert torch.equal(rows([(a, b)], ep.DOT)[0], ep.row_dot_ordered(a, b))
        assert torch.equal(rows([(a, None)], ep.SUM)[0], ep.row_dot_ordered(a))
        assert torch.equal(rows([(a, None)], ep.NORM)[0], torch.sqrt(ep.row_dot_ordered(a, a)))
        col = a[:, :1].expand(3, k)  # a broadcast operand: stride 0 along the row
        assert torch.equal(rows([(col, b)], ep.DOT)[0], ep.row_dot_ordered(col, b))
    # one launch a call, whatever the row's length
    assert ep.launches - before == 3 + 3 * 4
    assert {k: ep.launches_by[k] - before_by[k] for k in before_by} == {
        "gram": 1, "bmv": 2, "row_dot": 3 * 4}


@pytest.mark.parametrize("k", [16, 437, 300_000])
def test_row_dots_of_several_pairs_equal_each_pairs_dot(k):
    """``optim.common.dots`` of several pairs gives each pair's ``dot``
    (on the CPU the plain sums), and one row launch over up to eight pairs
    of one shape gives each pair's own launch's bits (emulated), in as
    many launches as groups of eight."""
    from photon_ml_tpu_torch.optim import common

    rng = np.random.default_rng(k)
    banks = [torch.as_tensor(rng.normal(size=(2, k)).astype(np.float32)) for _ in range(5)]
    pairs = [(banks[i % 5], banks[(i * 3 + 1) % 5]) for i in range(10)]
    for got, (a, b) in zip(common.dots(*pairs), pairs):
        assert torch.equal(got, common.dot(a, b))
    assert torch.equal(ep.row_dots(pairs), torch.stack([ep.row_dot(a, b) for a, b in pairs]))
    before = ep.launches_by["row_dot"]
    together = torch.cat([ep.run_rows(_emulated_rows_call, pairs[i:i + ep.MAX_PAIRS], ep.DOT)
                          for i in range(0, len(pairs), ep.MAX_PAIRS)])
    assert ep.launches_by["row_dot"] - before == 2
    for got, (a, b) in zip(together, pairs):
        assert torch.equal(got, ep.run_rows(_emulated_rows_call, [(a, b)], ep.DOT)[0])
        assert torch.equal(got, ep.row_dot_ordered(a, b))


def _emulated_gram(X, p, m):
    """The Gram kernel in plain PyTorch: an entity's rows zero-padded to
    W = P M (its shared-memory copy), every entry i <= j by one group's
    tree (each thread's M leaves q + P m halved, then the P threads
    halved), the upper triangle mirrored to the lower."""
    E, S, D = X.shape
    xs = torch.nn.functional.pad(X, (0, p * m - D))
    out = torch.empty(E, S, S, dtype=X.dtype)
    for i in range(S):
        for j in range(i, S):
            buf = (xs[:, i] * xs[:, j]).view(E, m, p)
            h = m // 2
            while h >= 1:
                buf = buf[:, :h] + buf[:, h:2 * h]
                h //= 2
            v = buf[:, 0]
            while v.shape[1] > 1:
                half = v.shape[1] // 2
                v = v[:, :half] + v[:, half:]
            out[:, i, j] = out[:, j, i] = v[:, 0]
    return out


@pytest.mark.parametrize("shape", [(6, 9, 37), (4, 16, 437), (3, 5, 3), (2, 7, 16), (2, 4, 1)])
def test_gram_kernel_plan_gives_the_ordered_gram(shape):
    """The Gram kernel's plan (a group of P threads for each entry i <= j
    of an entity's staged rows, mirrored) gives ``gram_ordered``'s bits;
    a block too wide or too large for shared memory takes the general
    kernel (no plan)."""
    rng = np.random.default_rng(shape[2])
    X = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    E, S, D = shape
    p, m = ep.gram_plan(S, D, 4)
    assert p * m == ep.padded_width(D) and p <= 32
    assert torch.equal(_emulated_gram(X, p, m), ep.gram_ordered(X))
    assert ep.gram_plan(S, 513, 4) is None
    assert ep.gram_plan(128, 437, 8) is None


@pytest.mark.parametrize("case", ["newton", "dense_owlqn_elastic", "dense_tron",
                                  "sparse_lbfgs", "sparse_owlqn_l1", "sparse_tron"])
def test_card_order_update_against_float64(case, monkeypatch):
    """The random-effect update in the card's order of additions (the
    wrappers replaced by their ``*_ordered`` forms, whose bits the kernel
    gives) in float32, against the same update in float64, on the inputs
    of ``test_torch_game_random_effect.py``'s residual-offsets test and a
    second residual: each entity's float64 objective at its float32 row
    is within the solver's tolerance (1e-6 of its objective at zero) of
    its objective at the float64 row. A float32 solve that stops on the
    function change leaves its row undetermined along flat directions,
    so the rows themselves are held by the objective (strong convexity
    bounds the row's error by sqrt(2 tol |f0| / l2))."""
    import dataclasses

    import test_torch_game_random_effect as ref_tests

    _, port_ds, _, red = ref_tests._re_datasets()
    _, problem = ref_tests._problems(case)
    l1, l2 = problem.regularization.split(1.0)
    E, D = red.num_entities, red.local_dim
    for seed in (0, 1):
        resid = np.random.default_rng(seed).normal(size=port_ds.num_rows).astype(np.float32) * 0.3
        bank64, _ = problem.update_bank(torch.zeros(E, D, dtype=torch.float64), red,
                                        residual_offsets=torch.as_tensor(resid, dtype=torch.float64))
        with monkeypatch.context() as mp:
            mp.setattr(ep, "row_dot", ep.row_dot_ordered)
            mp.setattr(ep, "row_norm", lambda a: torch.sqrt(ep.row_dot_ordered(a, a)))
            mp.setattr(ep, "bmv", ep.bmv_ordered)
            mp.setattr(ep, "gram", ep.gram_ordered)
            bank32, _ = problem.update_bank(torch.zeros(E, D), red,
                                            residual_offsets=torch.as_tensor(resid))
        shifted = dataclasses.replace(red, buckets=[
            dataclasses.replace(b, offsets=np.where(  # the residual replaces the offsets
                b.row_index >= 0, resid[np.maximum(b.row_index, 0)], 0.0))
            for b in red.buckets
        ])
        f0 = ref_tests._entity_objectives64(np.zeros((E, D)), shifted, l1, l2)
        f64 = ref_tests._entity_objectives64(bank64.numpy(), shifted, l1, l2)
        f32 = ref_tests._entity_objectives64(bank32.double().numpy(), shifted, l1, l2)
        assert np.all(f32 - f64 <= 1e-6 * np.abs(f0)), (case, seed, np.max((f32 - f64) / np.abs(f0)))
