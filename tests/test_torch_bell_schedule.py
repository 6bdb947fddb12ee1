"""The BELL SpMM kernel's schedule (csrc/bell.cu) emulated on the CPU.

The CUDA kernel runs only on the card. Here its schedule, from
``bell.launch_geometry`` (the m-tile chosen from m, the cluster size, the
slice width, the thread groups that split a slice's columns), runs in
float64 NumPy: a cluster a block row and m-tile, rank q of it walking
slices q, q + CL, ... of the block row's stored blocks (each block's
slices in turn, block after block), skipping a slice's
products only where the staged A slice is all zero and the staged X slice
all finite (the CTA's vote), each column group accumulating its columns,
then each rank summing its share of the output tile over the ranks in
rank order and the groups in order. It asserts that every slice of every
stored block is walked once an m-tile, that every output value is written
once, and that
rows of Xt past m read as zero; the result is held against
``bell.spmm_plain`` and JAX's ``bell.spmm`` (interpret mode) at rtol 1e-12
and atol 1e-12 * max|ref|, with NaN and Inf exactly where the plain
version has them. Cases: padding blocks, an unsorted ``cols``, a real
block at block column 0, NaN and Inf in Xt's first block column, m = 8 and
m = 128 (and the mid and partial m-tiles). The launch constants are read
from the kernel source.

bfloat16 storage (JAX's _cdt rule: a float32 accumulator, Yt rounded
once) takes slices of 64 block columns, 8 values a 16-byte chunk: the
schedule runs in float32 on the widened values (a product of two bfloat16
is exact there), the result is rounded to bfloat16 once and held against
``bell.spmm_plain`` by tests/test_torch_mixed.py's bfloat16 rule (within
one bfloat16 ulp plus BF16_SCALE_TOL of the largest value, at most
BF16_SHARE of the values differing), NaN and Inf where the plain version
has them.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from multigridcmt_tpu.kernels import bell as jbell
from multigridcmt_tpu_torch.kernels import _build, bell


BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-3


def _emulate_spmm(a: bell.BELL, xt: torch.Tensor, g: bell.SpmmGeometry):
    """csrc/bell.cu's kernel on geometry g, cluster by cluster; returns
    (Yt, slices multiplied, slices skipped). Sums in float64, or for
    bfloat16 storage in float32 on the widened values (Yt unrounded)."""
    acc_t = np.float32 if xt.dtype == torch.bfloat16 else np.float64
    data, cols = a.data.to(torch.float64).numpy().astype(acc_t), \
        a.cols.numpy()
    x = xt.to(torch.float64).numpy().astype(acc_t)
    nbr, kmax = cols.shape
    m = x.shape[0]
    mt_, cl, kc, cs = g.m_tile, g.cluster, g.slice_cols, g.col_groups
    cc = kc // cs
    slices = bell.BN // kc
    assert (bell.BM // g.rows) * (mt_ // g.vectors) * cs == bell.THREADS
    yt = np.full((m, nbr * bell.BM), np.nan, acc_t)
    writes = np.zeros(yt.shape, dtype=int)
    walked = np.zeros((g.m_tiles, nbr, kmax, slices), dtype=int)
    done = skipped = 0
    for i in range(nbr):
        for mt in range(g.m_tiles):
            j0 = mt * mt_
            # The X tile as staged: rows past m zero-filled.
            xs = np.zeros((mt_, x.shape[1]), acc_t)
            live = min(mt_, m - j0)
            xs[:live] = x[j0:j0 + live]
            partials = []
            for q in range(cl):
                acc = np.zeros((cs, mt_, bell.BM), acc_t)
                # Rank q's slices: q, q + cl, ... of the block row's walk.
                for s_ in range(q, kmax * slices, cl):
                    k, c0 = divmod(s_, slices)
                    c0 *= kc
                    walked[mt, i, k, c0 // kc] += 1
                    col = int(cols[i, k]) * bell.BN
                    av = data[i, k, :, c0:c0 + kc]
                    xv = xs[:, col + c0:col + c0 + kc]
                    if not (av != 0).any() and np.isfinite(xv).all():
                        skipped += 1
                        continue
                    done += 1
                    for grp in range(cs):
                        sl = slice(grp * cc, (grp + 1) * cc)
                        with np.errstate(invalid="ignore"):
                            acc[grp] += xv[:, sl] @ av[:, sl].T
                partials.append(acc.reshape(cs, -1))
            share = mt_ * bell.BM // cl
            for q in range(cl):
                e = slice(q * share, (q + 1) * share)
                total = partials[0][0, e].copy()
                for src in range(cl):
                    for grp in range(cs):
                        if src or grp:
                            with np.errstate(invalid="ignore"):
                                total += partials[src][grp, e]
                tile = total.reshape(-1, bell.BM)
                j = j0 + q * share // bell.BM + np.arange(tile.shape[0])
                keep = j < m
                r = slice(i * bell.BM, (i + 1) * bell.BM)
                yt[j[keep], r] = tile[keep]
                writes[j[keep], r] += 1
    assert (walked == 1).all(), "a slice walked more or less than once"
    assert (writes == 1).all(), "an output written more or less than once"
    return yt, done, skipped


def _block_random(nbr, nbc, density, seed, col0=True):
    """Blocks of N(0,1) values at ``density``; with ``col0`` block row 0
    has a real block at block column 0 (which padding blocks also name)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbr, nbc)) < density
    mask[:, 1 % nbc] = True
    mask[0, 0] = col0
    dense = np.zeros((nbr * 128, nbc * 128))
    for i, j in zip(*np.nonzero(mask)):
        dense[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = (
            rng.standard_normal((128, 128)))
    return sp.csr_matrix(dense)


def _xt(m, width, seed, nonfinite=False):
    x = np.random.default_rng(seed).standard_normal((m, width))
    if nonfinite:
        # Xt's first block column, where every padding block points.
        x[0, 5] = np.nan
        x[m - 1, 100] = np.inf
        x[m // 2, 127] = -np.inf
        x[1, 200] = np.nan
    return torch.from_numpy(x)


def _reversed(a: bell.BELL) -> bell.BELL:
    """The same matrix with each block row's stored blocks in reverse
    order: padding first, cols unsorted."""
    return bell.BELL(data=a.data.flip(1).contiguous(),
                     cols=a.cols.flip(1).contiguous(), shape=a.shape,
                     nnz_scalar=a.nnz_scalar)


def _same(got, want):
    """NaN and +-Inf where ``want`` has them; the finite values close."""
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12,
                               atol=1e-12 * np.abs(want[fin]).max())


# (block rows, block columns, density, kmax padding added, m, Xt with NaN
# and Inf in its first block column, blocks reversed (unsorted cols), a
# real block at block column 0)
CASES = [
    (3, 4, 0.5, 3, 8, False, False, True),
    (3, 4, 0.5, 3, 128, False, False, True),
    (3, 4, 0.5, 3, 8, True, False, True),
    (3, 4, 0.5, 3, 128, True, False, True),
    (2, 5, 0.6, 2, 128, True, True, True),
    (2, 5, 0.6, 2, 8, True, True, False),
    (4, 3, 0.4, 1, 16, False, True, True),
    (4, 3, 0.4, 0, 40, True, False, False),
    (1, 6, 0.7, 4, 136, True, True, True),
    (5, 2, 1.0, 0, 24, False, False, True),
]


@pytest.mark.parametrize("nbr,nbc,dens,pad,m,nonfinite,rev,col0", CASES)
def test_schedule_matches_plain(nbr, nbc, dens, pad, m, nonfinite, rev,
                                col0):
    a_sp = _block_random(nbr, nbc, dens, 7 * nbr + nbc + m, col0)
    tight = bell.bell_from_scipy(a_sp, dtype=torch.float64, device="cpu")
    a = bell.bell_from_scipy(a_sp, dtype=torch.float64, kmax=tight.kmax + pad,
                             device="cpu")
    if rev:
        a = _reversed(a)
    xt = _xt(m, nbc * 128, m + nbr, nonfinite)
    g = bell.launch_geometry(a.nbr, a.kmax, m, torch.float64)
    got, done, skipped = _emulate_spmm(a, xt, g)
    want = bell.spmm_plain(a, xt)
    _same(got, want)
    # A padding block's slices are skipped only where Xt's slice is finite.
    stored = a.nbr * a.kmax * g.m_tiles * (bell.BN // g.slice_cols)
    assert done + skipped == stored
    padding = (a.data.reshape(a.nbr, a.kmax, -1) == 0).all(-1)
    if padding.any() and not nonfinite:
        assert skipped >= int(padding.sum()) * (bell.BN // g.slice_cols)
    # NaN from a padding block reaches every row of its block row.
    if nonfinite and padding.any():
        i = int(np.nonzero(padding.numpy())[0][0])
        assert np.isnan(got[0, i * 128:(i + 1) * 128]).all()


def _bf16_same(got, want):
    """got (the emulation rounded to bfloat16) against want (the plain
    version's bfloat16 Yt): NaN and +-Inf where want has them; the finite
    values by the module's bfloat16 rule."""
    g, w = got.double().numpy(), want.double().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
    fin = np.isfinite(w)
    g, w = g[fin], w[fin]
    diff = np.abs(g - w)
    _, ex = np.frexp(w)
    ulp = np.where(w != 0, np.ldexp(1.0, ex - 8), 0.0)
    assert np.all(diff <= ulp + BF16_SCALE_TOL * np.abs(w).max())
    assert np.mean(diff > 0) <= BF16_SHARE


@pytest.mark.parametrize("nbr,nbc,dens,pad,m,nonfinite,rev,col0", [
    CASES[0], CASES[3], CASES[5], CASES[6], CASES[7]])
def test_schedule_matches_plain_bf16(nbr, nbc, dens, pad, m, nonfinite, rev,
                                     col0):
    """bfloat16 storage: slices of 64 block columns (8 values a 16-byte
    chunk), the same cluster split and column groups, each slice walked
    once, padding slices skipped where Xt is finite; held against
    spmm_plain by the bfloat16 rule."""
    a_sp = _block_random(nbr, nbc, dens, 7 * nbr + nbc + m, col0)
    tight = bell.bell_from_scipy(a_sp, device="cpu")
    a = bell.bell_from_scipy(a_sp, dtype=torch.bfloat16,
                             kmax=tight.kmax + pad, device="cpu")
    if rev:
        a = _reversed(a)
    xt = _xt(m, nbc * 128, m + nbr, nonfinite).to(torch.bfloat16)
    g = bell.launch_geometry(a.nbr, a.kmax, m, torch.bfloat16)
    assert (g.slice_cols, bell.SLICE_BYTES // g.slice_cols) == (64, 2)
    got, done, skipped = _emulate_spmm(a, xt, g)
    assert got.dtype == np.float32
    _bf16_same(torch.from_numpy(got).to(torch.bfloat16),
               bell.spmm_plain(a, xt))
    stored = a.nbr * a.kmax * g.m_tiles * (bell.BN // g.slice_cols)
    assert done + skipped == stored
    padding = (a.data.reshape(a.nbr, a.kmax, -1) == 0).all(-1)
    if padding.any() and not nonfinite:
        assert skipped >= int(padding.sum()) * (bell.BN // g.slice_cols)


@pytest.mark.parametrize("m,nonfinite", [(8, False), (16, True),
                                         (128, True)])
def test_schedule_matches_jax(m, nonfinite):
    """The emulated kernel against JAX's spmm (its Pallas kernel in
    interpret mode) with padding blocks and unsorted cols."""
    a_sp = _block_random(3, 3, 0.4, 5 + m)
    tight = bell.bell_from_scipy(a_sp, dtype=torch.float64, device="cpu")
    a = _reversed(bell.bell_from_scipy(a_sp, dtype=torch.float64,
                                       kmax=tight.kmax + 2, device="cpu"))
    ja = jbell.BELL(data=jnp.asarray(a.data.numpy()),
                    cols=jnp.asarray(a.cols.numpy()), shape=a.shape,
                    nnz_scalar=a.nnz_scalar)
    xt = _xt(m, 3 * 128, 9, nonfinite)
    want = np.asarray(jbell.spmm(ja, jnp.asarray(xt.numpy())))
    got, *_ = _emulate_spmm(a, xt,
                            bell.launch_geometry(a.nbr, a.kmax, m,
                                                 torch.float64))
    _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_m_tile_choice(dtype):
    """The m-tile is the least of the dtype's tiles that holds m, else the
    largest, several of it: the SpMV carrier (m = 8) computes an 8-row
    tile, not a 32-row one. The thread groups fill the CTA. bfloat16 takes
    float32's m-tiles and register tiles (its accumulator is float32) on
    slices of 64 block columns."""
    wide = 32 if dtype == torch.float64 else 128
    for m, tile in ((8, 8), (16, 32), (32, 32), (40, wide), (64, wide),
                    (128, wide), (136, wide), (512, wide)):
        g = bell.launch_geometry(64, 18, m, dtype)
        assert (g.m_tile, g.m_tiles) == (tile, -(-m // tile))
        assert (bell.BM // g.rows) * (tile // g.vectors) * g.col_groups \
            == bell.THREADS
        # A column group takes whole 16-byte chunks of a slice.
        per = {torch.float32: 4, torch.float64: 2, torch.bfloat16: 8}[dtype]
        assert g.slice_cols % (g.col_groups * per) == 0
        assert g.slice_cols * (16 // per) == bell.SLICE_BYTES
    g = bell.launch_geometry(64, 18, 128, torch.float32)
    assert (g.rows, g.vectors, g.col_groups, g.slice_cols) == (8, 8, 1, 32)
    g = bell.launch_geometry(64, 18, 128, torch.bfloat16)
    assert (g.rows, g.vectors, g.col_groups, g.slice_cols) == (8, 8, 1, 64)
    g = bell.launch_geometry(64, 18, 8, torch.bfloat16)
    assert (g.rows, g.col_groups, g.slice_cols) == (4, 8, 64)


def test_slice_striding_balances_a_block_row():
    """Rank q of a cluster takes slices q, q + CL, ...: at the bench's
    shape (64 x 64 blocks, density 0.15, seed 1; kmax 18, CL 8) every rank
    of a block row gets the same populated slices within one, where
    striding whole blocks would leave ranks of 17 and 18 populated blocks
    with 3 against 2."""
    rng = np.random.default_rng(1)
    mask = rng.random((64, 64)) < 0.15
    mask[np.arange(64), np.arange(64)] = True
    g = bell.launch_geometry(64, int(mask.sum(1).max()), 128, torch.float32)
    slices = bell.BN // g.slice_cols
    assert g.cluster == 8 and slices == 4
    for n in mask.sum(1):
        # bell_from_scipy stores a block row's populated blocks first.
        populated = np.arange(18 * slices) < n * slices
        per_rank = [populated[q::g.cluster].sum() for q in range(g.cluster)]
        assert max(per_rank) - min(per_rank) <= 1


def test_cluster_rule():
    """The cluster doubles up to 8 while the launch has fewer than 4 CTAs
    an SM and the block row has the slices: 8 at the bench shape at m =
    128 and m = 8 (512 CTAs on 132 SMs), less where the grid is large."""
    f32, f64 = torch.float32, torch.float64
    assert bell.launch_geometry(64, 18, 128, f32).cluster == 8
    assert bell.launch_geometry(64, 18, 8, f32).cluster == 8
    assert bell.launch_geometry(64, 18, 128, f64).cluster == 4  # 4 m-tiles
    assert bell.launch_geometry(64, 1, 8, f32).cluster == 4   # 4 slices
    assert bell.launch_geometry(64, 1, 8, f64).cluster == 8
    assert bell.launch_geometry(200, 18, 8, f32).cluster == 4
    assert bell.launch_geometry(300, 18, 8, f32).cluster == 2
    assert bell.launch_geometry(600, 18, 128, f32).cluster == 1
    assert bell.launch_geometry(64, 18, 8, f32, sm_count=16).cluster == 1
    for nbr in range(1, 80, 7):
        for kmax in range(1, 20, 3):
            g = bell.launch_geometry(nbr, kmax, 8, f32)
            cl = g.cluster
            assert cl & (cl - 1) == 0
            assert 1 <= cl <= min(8, kmax * bell.BN // g.slice_cols)


def test_launch_constants_match_the_kernel_source():
    """bell.py's launch constants are the ones csrc/bell.cu compiles with,
    the kernel keeps its entry points and arguments, launches a cluster
    and stages by cp.async, and sums the partial tiles with no atomics."""
    src = (_build.CSRC / "bell.cu").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads"] == bell.THREADS
    assert const["kSliceBytes"] == bell.SLICE_BYTES
    assert const["kStages"] == bell.STAGES >= 2
    assert const["kMaxCluster"] == bell.MAX_CLUSTER
    assert const["kCtasPerSm"] == bell.CTAS_PER_SM
    assert (const["kMTileSmall"], const["kMTileMid"],
            const["kMTileF32"]) == bell.M_TILES[torch.float32]
    assert (const["kMTileSmall"],
            const["kMTileMid"]) == bell.M_TILES[torch.float64]
    assert (const["kMTileSmall"], const["kMTileMid"],
            const["kMTileF32"]) == bell.M_TILES[torch.bfloat16]
    # The geometry takes its chunk and slice from the stored value's size
    # (a bfloat16 chunk of 16 bytes is 8 values), the register tile and
    # the partial tiles' bytes from the accumulator's.
    assert "static constexpr int B = static_cast<int>(sizeof(S));" in src
    assert "static constexpr int V = 16 / B;" in src
    assert "static constexpr int KC = kSliceBytes / B;" in src
    assert "PART * static_cast<int>(sizeof(T))" in src
    assert "launch<float, __nv_bfloat16>" in src
    assert const["kTileRows"] == bell.TILE_ROWS
    assert const["kTileRowsWide"] == bell.TILE_ROWS_WIDE
    assert const["kTileVectors"] == bell.TILE_VECTORS
    for t in ("f32", "f64", "bf16"):
        m = re.search(rf"\bint mg_bell_spmm_{t}\(([^)]*)\)\s*\{{", src)
        assert len(m.group(1).split(",")) == len(
            _build.SIGNATURES[f"mg_bell_spmm_{t}"])
    for token in ("cudaLaunchAttributeClusterDimension", "cp.async.cg",
                  "cp.async.wait_group", "__syncthreads_or",
                  "map_shared_rank", "cluster.sync()"):
        assert token in src, token
    assert not re.search(r"\batomic\w*\(", src)
