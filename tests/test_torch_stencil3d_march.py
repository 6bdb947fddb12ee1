"""The z-march of csrc/stencil3d.cu, emulated step by step on the CPU.

The CUDA kernels cannot run here, so these tests replay their schedule:
each unit (one warp: a strip of columns by a band of rows, marching over a
chunk of planes) with its 32 lanes as a numpy axis, its register rings of
MARCH_SLOTS planes as tagged slots (a slot read for a plane it no longer
holds fails), the warp shuffles as shifts whose edge lane reads NaN (the
kernel's edge lanes read their own value, which no owned point may use),
and the loads, red and black updates and stores in the kernel's order.
The geometry is march_geometry's, the ints the wrapper passes to the
kernel, decoded here as the kernel's Unit decodes them; a test that wants
other chunks sets MARCH_CHUNK and MARCH_MIN_UNITS, which march_geometry
reads. The emulation is held against the plain versions in float64 at
rtol 1e-12: both evaluate the same formulas in the same order (numpy
does not contract into FMAs), so they agree to the last bit or nearly;
1e-12 leaves room for nothing but rounding. The bfloat16 storage modes
are emulated in float32 on bfloat16 values, with the red values rounded
to bfloat16 before the black stage reads them and each output rounded
once on its store, and held against the plain versions by the bfloat16
rule of tests/test_torch_mixed3d.py.
"""
import re

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import _build, stencil3d

SIGMA = 11.5
OMEGA = 6.0 / 7.0
LANES = stencil3d.MARCH_LANES
SLOTS = stencil3d.MARCH_SLOTS
F32 = torch.float32


class _Geom:
    """march_geometry's ints for ``mode`` on a (p, r, c) stack, decoded as
    csrc/stencil3d.cu's Unit decodes them, with the band rows and column
    halo the kernel compiles with."""

    def __init__(self, mode, p, r, c, dtype):
        kernel = "rbgs" if mode == "rbgs" else "pass"
        self.p, self.r, self.c = p, r, c
        self.halo = 2 if kernel == "rbgs" else 1
        self.rows = stencil3d.MARCH_ROWS[kernel, dtype]
        (self.strips, self.bands, self.chunks, self.width,
         self.chunk) = stencil3d.march_geometry(kernel, p, r, c, dtype)

    def units(self):
        return self.strips * self.bands * self.chunks

    def unit(self, index):
        """(sx, sy, sz) of unit ``index``."""
        return (index % self.strips, index // self.strips % self.bands,
                index // (self.strips * self.bands))

    def cols(self, sx):
        """(first, end) of strip sx's columns."""
        return sx * self.width, min((sx + 1) * self.width, self.c)

    def band(self, sy):
        """(first, end) of band sy's rows."""
        return sy * self.rows, min((sy + 1) * self.rows, self.r)

    def planes(self, sz):
        """(first, end) of chunk sz's planes."""
        return sz * self.chunk, min((sz + 1) * self.chunk, self.p)


@pytest.fixture
def chunk_of(monkeypatch):
    """Geometry with chunks of at most ``chunk`` planes, whatever the unit
    count: sets the constants march_geometry reads."""
    def geometry(mode, shape, dtype, chunk):
        kernel = "rbgs" if mode == "rbgs" else "pass"
        monkeypatch.setitem(stencil3d.MARCH_CHUNK, kernel, chunk)
        monkeypatch.setattr(stencil3d, "MARCH_MIN_UNITS", 1)
        return _Geom(mode, *shape, dtype)
    return geometry


class _Ring:
    """A register ring: plane q lives in slot (q - z0) mod MARCH_SLOTS."""

    def __init__(self, z0):
        self.z0 = z0
        self.data = [None] * SLOTS
        self.tag = [None] * SLOTS

    def put(self, q, v):
        k = (q - self.z0) % SLOTS
        self.data[k], self.tag[k] = v, q

    def get(self, q):
        k = (q - self.z0) % SLOTS
        assert self.tag[k] == q, f"slot of plane {q} holds {self.tag[k]}"
        return self.data[k]


def _left(v):
    """Each lane's lane - 1 value (__shfl_up_sync); lane 0 reads NaN."""
    out = np.roll(v, 1, axis=-1)
    out[..., 0] = np.nan
    return out


def _right(v):
    out = np.roll(v, -1, axis=-1)
    out[..., -1] = np.nan
    return out


def _nsum(lo, hi, mid, cur):
    """The neighbour sum in the kernel's order; mid has a row above and
    below cur's."""
    return ((((lo + hi) + mid[:-2]) + mid[2:]) + _left(cur)) + _right(cur)


class _Unit:
    """One warp's unit, as csrc/stencil3d.cu's Unit: region row j of a lane
    is stack row y0 - H + j; masks are (rows, lanes) arrays."""

    def __init__(self, g, index, n, goff, roff):
        H, R = g.halo, g.rows
        sx, sy, sz = g.unit(index)
        lane = np.arange(LANES)
        self.x = sx * g.width - H + lane
        self.y0 = sy * R
        self.z0, self.z1 = g.planes(sz)
        self.ys = self.y0 - H + np.arange(R + 2 * H)
        x, y = self.x[None, :], self.ys[:, None]
        col = (lane < g.width + 2 * H) & (self.x >= 0) & (self.x < g.c)
        core = (lane >= H) & (lane < H + g.width) & (self.x < g.c)
        self.rows = col & (y >= 0) & (y < g.r)
        self.upd = (col & (y >= 1) & (y <= g.r - 2) & (y + roff >= 1)
                    & (y + roff <= n) & (x >= 1) & (x <= n))
        j = np.arange(R + 2 * H)[:, None]
        self.mine = core & (j >= H) & (j < H + R) & (y < g.r)
        self.red_base = (goff + y + roff + x) & 1      # + q: red where even
        self.g, self.n, self.goff = g, n, goff

    def valid(self, q):
        gz = q + self.goff
        return 1 <= q <= self.g.p - 2 and 1 <= gz <= self.n

    def red(self, q):
        return (self.red_base + q) % 2 == 0

    def load(self, a, q, qend, j0, count, mask):
        """Rows j0 .. j0 + count of plane q; 0 off the stack, outside the
        mask and for planes outside [0, qend)."""
        g = self.g
        if not 0 <= q < min(qend, g.p):
            return np.zeros((count, LANES), dtype=a.dtype)
        yy = np.clip(self.ys[j0:j0 + count], 0, g.r - 1)
        xx = np.clip(self.x, 0, g.c - 1)
        return np.where(mask[j0:j0 + count], a[q][yy][:, xx], 0.0)

    def store(self, out, writes, q, v, k):
        """Store region rows k .. k + len(v) where this lane owns them."""
        for i in range(v.shape[0]):
            own = self.mine[k + i]
            if not own.any():
                continue
            y = self.ys[k + i]
            out[q, y, self.x[own]] = v[i, own]
            writes[q, y, self.x[own]] += 1


def _steps(z0, z1):
    """The kernel's z-loop: steps z0 .. z1 - 1, unrolled by MARCH_SLOTS;
    yields (phase K, z)."""
    for z in range(z0, z1, SLOTS):
        for k in range(SLOTS):
            if z + k == z1:
                return
            yield k, z + k


def _keep(v):
    return v


def _emulate_rbgs(g, u, b, n, h, sigma, goff, roff, red_store=_keep,
                  out_store=_keep):
    """rbgs_kernel on geometry g; returns (out, writes a point). Each red
    value is stored in the red ring as ``red_store`` leaves it, each output
    as ``out_store`` does (the storage rule; identities by default)."""
    h2 = h * h
    inv_den = 1.0 / (6.0 - sigma * h2)
    out = np.full_like(u, np.nan)
    writes = np.zeros(u.shape, dtype=int)
    lane = np.arange(LANES)
    for index in range(g.units()):
        t = _Unit(g, index, n, goff, roff)
        bmask = t.rows & ((lane >= 1) & (lane <= g.width + 2))
        nr = g.rows + 2
        U, B, Rr = _Ring(t.z0), _Ring(t.z0), _Ring(t.z0)

        def load_u(q):
            U.put(q, t.load(u, q, t.z1 + 2, 0, g.rows + 4, t.rows))

        def load_b(q):
            B.put(q, t.load(b, q, t.z1 + 1, 1, nr, bmask))

        def red(q):
            lo, mid, hi = U.get(q - 1), U.get(q), U.get(q + 1)
            cur = mid[1:-1]
            gs = (h2 * B.get(q) + _nsum(lo[1:-1], hi[1:-1], mid, cur)) \
                * inv_den
            upd = (t.upd & t.red(q))[1:-1] if t.valid(q) else False
            Rr.put(q, np.where(upd, red_store(gs), cur))

        def black(q):
            lo, mid, hi = Rr.get(q - 1), Rr.get(q), Rr.get(q + 1)
            cur = mid[1:-1]
            gs = (h2 * B.get(q)[1:-1]
                  + _nsum(lo[1:-1], hi[1:-1], mid, cur)) * inv_den
            if t.valid(q):
                v = np.where((t.upd & ~t.red(q))[2:-2], gs, cur)
            else:
                v = np.zeros_like(cur)
            t.store(out, writes, q, out_store(v), 2)

        z0 = t.z0
        for q in (z0 - 2, z0 - 1, z0, z0 + 1):
            load_u(q)
        load_b(z0 - 1)
        load_b(z0)
        red(z0 - 1)
        load_u(z0 + 2)
        load_b(z0 + 1)
        red(z0)
        for _, z in _steps(z0, t.z1):
            load_u(z + 3)
            load_b(z + 2)
            red(z + 1)
            black(z)
    return out, writes


def _emulate_pass(g, mode, u, b, n, h, sigma, goff, roff, omega=1.0,
                  out_store=_keep):
    """pass_kernel (residual or Jacobi) on geometry g, each output stored
    as ``out_store`` leaves it."""
    inv_h2 = 1.0 / (h * h)
    jscale = omega / (6.0 * inv_h2 - sigma)
    out = np.full_like(u, np.nan)
    writes = np.zeros(u.shape, dtype=int)
    for index in range(g.units()):
        t = _Unit(g, index, n, goff, roff)
        U, B = _Ring(t.z0), _Ring(t.z0)

        def load_u(q):
            U.put(q, t.load(u, q, t.z1 + 1, 0, g.rows + 2, t.rows))

        def load_b(q):
            B.put(q, t.load(b, q, t.z1, 1, g.rows, t.mine))

        def apply(q):
            lo, mid, hi = U.get(q - 1), U.get(q), U.get(q + 1)
            cur = mid[1:-1]
            total = _nsum(lo[1:-1], hi[1:-1], mid, cur)
            res = B.get(q) - (6.0 * cur - total) * inv_h2 + sigma * cur
            upd = t.upd[1:-1] if t.valid(q) else np.zeros_like(cur, bool)
            if mode == "residual":
                v = np.where(upd, res, 0.0)
            else:
                v = np.where(upd, cur + jscale * res, cur)
            if not t.valid(q):
                v = np.zeros_like(cur)
            t.store(out, writes, q, out_store(v), 1)

        z0 = t.z0
        for q in (z0 - 1, z0, z0 + 1):
            load_u(q)
        load_b(z0)
        for _, z in _steps(z0, t.z1):
            load_u(z + 2)
            load_b(z + 1)
            apply(z)
    return out, writes


def _emulate(mode, g, u, b, n, h, sigma, goff, roff, sweeps=1):
    if mode == "rbgs":
        for _ in range(sweeps):
            u, writes = _emulate_rbgs(g, u, b, n, h, sigma, goff, roff)
            assert (writes == 1).all()
        return u
    out, writes = _emulate_pass(g, mode, u, b, n, h, sigma, goff, roff,
                                omega=OMEGA)
    assert (writes == 1).all()
    return out


def _plain(mode, u, b, n, h, sigma, goff, roff, sweeps=1):
    ut, bt = torch.from_numpy(u), torch.from_numpy(b)
    kw = dict(sigma=sigma, goff=goff, roff=roff)
    if mode == "rbgs":
        return stencil3d.rbgs_sweep_plain(ut, bt, n, h, sweeps=sweeps,
                                          **kw).numpy()
    if mode == "jacobi":
        return stencil3d.jacobi_sweep_plain(ut, bt, n, h, OMEGA,
                                            **kw).numpy()
    return stencil3d.residual_plain(ut, bt, n, h, **kw).numpy()


def _grids(n, seed):
    rng = np.random.default_rng(seed)
    u = np.zeros((n + 2,) * 3)
    b = np.zeros_like(u)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3)
    b[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3) * (n + 1) ** 2
    return u, b


def _stack(n, goff, roff, p, r, seed):
    """Planes goff .. goff + p - 1 and rows roff .. roff + r - 1 of a
    random (n+2)^3 grid, zero where they leave it."""
    u, b = _grids(n, seed)
    out = []
    for g in (u, b):
        s = np.zeros((p, r, n + 2))
        planes = g[max(goff, 0):goff + p]
        z = max(0, -goff)
        lo = max(roff, 0)
        rows = planes[:, lo:roff + r]
        s[z:z + rows.shape[0], lo - roff:lo - roff + rows.shape[1]] = rows
        out.append(s)
    return out


def _check(mode, g, u, b, n, sigma, goff=0, roff=0, sweeps=1):
    h = 1.0 / (n + 1)
    got = _emulate(mode, g, u, b, n, h, sigma, goff, roff, sweeps)
    want = _plain(mode, u, b, n, h, sigma, goff, roff, sweeps)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-12 * np.abs(want).max(), err


# (n, chunk override): n=31 is 33 planes, rows and columns: 2 strips of 28
# (one of 5 columns) for RB-GS, of 30 (3) for the pass; chunks of 7 give 5
# (the last of 5 planes), of 4 give 9 (whole ring turns), of 33 one.
_CUBE = [(31, 7), (31, 4), (31, 33), (15, 5)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
@pytest.mark.parametrize("n,chunk", _CUBE)
def test_rbgs_march_matches_plain(n, chunk, sigma, dtype, chunk_of):
    """The one-pass sweep on whole grids, with the band rows of each dtype
    (the arithmetic stays float64)."""
    u, b = _grids(n, seed=n + chunk)
    g = chunk_of("rbgs", u.shape, dtype, chunk)
    _check("rbgs", g, u, b, n, sigma)


@pytest.mark.parametrize("mode", ["residual", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,chunk", [(31, 7), (31, 4), (15, 16)])
def test_pass_march_matches_plain(mode, n, chunk, dtype, chunk_of):
    u, b = _grids(n, seed=2 * n + chunk)
    g = chunk_of(mode, u.shape, dtype, chunk)
    _check(mode, g, u, b, n, SIGMA)


# Stacks (n, goff, roff, p, r, chunk): chip_smoke.py's slab-and-pencil
# stack (global planes 100..139 of n=127, past the ghost plane 128 zero;
# rows -2..57); a stack of 3 planes; p equal to the chunk and one either
# side of it.
_STACKS = [(127, 100, -2, 40, 60, 16), (31, 5, 3, 3, 20, 64),
           (31, -1, 0, 16, 33, 16), (31, 4, -1, 15, 34, 16),
           (31, 9, 2, 17, 25, 16)]


@pytest.mark.parametrize("mode", ["rbgs", "residual", "jacobi"])
@pytest.mark.parametrize("n,goff,roff,p,r,chunk", _STACKS)
def test_march_on_offset_stacks(mode, n, goff, roff, p, r, chunk,
                                chunk_of):
    u, b = _stack(n, goff, roff, p, r, seed=p + r)
    g = chunk_of(mode, (p, r, n + 2), torch.float64, chunk)
    _check(mode, g, u, b, n, SIGMA, goff=goff, roff=roff)


def test_rbgs_march_chained_sweeps(chunk_of):
    """Two sweeps, each a launch: the second reads the first's output."""
    n = 31
    u, b = _grids(n, seed=5)
    g = chunk_of("rbgs", u.shape, torch.float32, 8)
    _check("rbgs", g, u, b, n, SIGMA, sweeps=2)


def _bf16(a):
    """a rounded to bfloat16 (to nearest even), held in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulate_bf16(mode, g, u, b, n, h, sweeps, out, round_red=True,
                  sigma=SIGMA, goff=0, roff=0):
    """The bfloat16 storage mode of ``mode``: u and b bfloat16 values in
    float32, the arithmetic in float32, every sweep's output rounded to
    bfloat16 but the last one's with out=float32 (the residual's always
    float32); with ``round_red`` the red ring rounded to bfloat16. The
    pass modes run one sweep."""
    if mode != "rbgs":
        store = _bf16 if mode == "jacobi" and out is None else _keep
        got, writes = _emulate_pass(g, mode, u, b, n, h, sigma, goff, roff,
                                    omega=OMEGA, out_store=store)
        assert (writes == 1).all()
        return got
    for i in range(sweeps):
        store = _keep if (out is not None and i == sweeps - 1) else _bf16
        u, writes = _emulate_rbgs(g, u, b, n, h, sigma, goff, roff,
                                  red_store=_bf16 if round_red else _keep,
                                  out_store=store)
        assert (writes == 1).all()
    return u


def _bf16_rule_share(got, want):
    """The share of points where got (float32) parts from want (the plain
    version's output), after asserting every point within one bfloat16 ulp
    of it plus 1e-5 of the field's largest value."""
    assert np.isfinite(got).all() and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    _, ex = np.frexp(want)
    ulp = np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)
    assert np.all(diff <= ulp + 1e-5 * np.abs(want).max())
    return np.mean(diff > 0)


# (mode, sweeps, out_dtype): each bfloat16 mode, RB-GS also chained.
_BF16_CASES = [("residual", 1, None), ("jacobi", 1, None),
               ("jacobi", 1, torch.float32), ("rbgs", 1, None),
               ("rbgs", 1, torch.float32), ("rbgs", 2, None)]


@pytest.mark.parametrize("mode,sweeps,out", _BF16_CASES)
def test_bf16_march_matches_plain(mode, sweeps, out, chunk_of):
    """The bfloat16 storage modes on the march (bfloat16's band rows,
    chunks of 7 planes at n=31) against the plain versions on the bfloat16
    tensors: at most 1e-3 of the points differ (numpy rounds each float32
    operation as the plain version does), none by more than the bfloat16
    rule."""
    n = 31
    u, b = (_bf16(a) for a in _grids(n, seed=11 + sweeps))
    g = chunk_of(mode, u.shape, torch.bfloat16, 7)
    h = 1.0 / (n + 1)
    got = _emulate_bf16(mode, g, u, b, n, h, sweeps, out)
    ut, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, b))
    kw = dict(sigma=SIGMA)
    if mode == "residual":
        want = stencil3d.residual_plain(ut, bt, n, h, **kw)
    elif mode == "jacobi":
        want = stencil3d.jacobi_sweep_plain(ut, bt, n, h, OMEGA,
                                            out_dtype=out, **kw)
    else:
        want = stencil3d.rbgs_sweep_plain(ut, bt, n, h, sweeps=sweeps,
                                          out_dtype=out, **kw)
    assert want.dtype == (torch.bfloat16 if mode != "residual"
                          and out is None else torch.float32)
    assert _bf16_rule_share(got, want.double().numpy()) <= 1e-3


def test_bf16_march_must_round_the_red_ring(chunk_of):
    """The rule above has the power to see the red ring's rounding: a march
    whose red values stay float32 parts from the plain version at far more
    than 1e-3 of the points (the black values read them)."""
    n = 31
    u, b = (_bf16(a) for a in _grids(n, seed=12))
    g = chunk_of("rbgs", u.shape, torch.bfloat16, 7)
    h = 1.0 / (n + 1)
    got = _emulate_bf16("rbgs", g, u, b, n, h, 1, torch.float32,
                        round_red=False)
    want = stencil3d.rbgs_sweep_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (u, b)), n, h,
        sigma=SIGMA, out_dtype=torch.float32).double().numpy()
    assert np.mean(np.abs(got - want) > 0) > 0.1


_GEOMETRY_SHAPES = [(513, 513, 513), (257, 257, 257), (129, 129, 129),
                    (40, 60, 129), (3, 20, 33), (64, 64, 64), (65, 65, 65),
                    (63, 63, 63)]


@pytest.mark.parametrize("mode", ["rbgs", "residual", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", _GEOMETRY_SHAPES)
def test_march_geometry_owns_each_point_once(mode, dtype, shape):
    """Every plane, row and column of the stack lies in exactly one chunk,
    band and strip (so every point in one unit), each of them non-empty;
    a strip's lanes with its halo fit the warp; the geometry passes the
    kernel's own check (geom_fits)."""
    g = _Geom(mode, *shape, dtype)
    p, r, c = shape
    for count, part, size in ((g.chunks, g.planes, p), (g.bands, g.band, r),
                              (g.strips, g.cols, c)):
        seen = np.zeros(size, dtype=int)
        for i in range(count):
            lo, hi = part(i)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
    assert g.width + 2 * g.halo <= LANES
    assert g.rows == stencil3d.MARCH_ROWS["rbgs" if mode == "rbgs"
                                          else "pass", dtype]
    assert g.rows + 2 * g.halo <= 32      # the kernel's row bit masks
    kernel = "rbgs" if mode == "rbgs" else "pass"
    assert g.chunk <= stencil3d.MARCH_CHUNK[kernel]
    # Enough units to fill the card, or chunks of one plane.
    assert g.units() >= stencil3d.MARCH_MIN_UNITS or g.chunk == 1
    units = {g.unit(i) for i in range(g.units())}
    assert len(units) == g.units() == g.strips * g.bands * g.chunks


def test_march_constants_match_the_kernel_source():
    """stencil3d's MARCH_* constants and the geometry's ints are the ones
    csrc/stencil3d.cuh (the march of stencil3d.cu and stencil3d_bf16.cu)
    compiles with; bfloat16 storage takes float32's rows (Rows<float>)."""
    src = (_build.CSRC / "stencil3d.cuh").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kLanes"] == LANES
    assert const["kWarps"] == stencil3d.MARCH_WARPS
    assert const["kSlots"] == SLOTS
    for (kernel, dtype), rows in stencil3d.MARCH_ROWS.items():
        key = ("kRbgsRows" if kernel == "rbgs" else "kPassRows") + \
            ("F64" if dtype == torch.float64 else "F32")
        assert const[key] == rows
    fields = re.search(r"struct Geom \{\s*int ([^;]*);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        "strips", "bands", "chunks", "width", "chunk"]
    assert len(stencil3d.march_geometry("rbgs", 33, 33, 33,
                                        torch.float32)) == 5


def test_rbgs_signature_takes_no_scratch_grid():
    """One launch a sweep: u, b and out, no scratch grid."""
    for t in ("f32", "f64"):
        args = _build.SIGNATURES[f"mg_stencil3d_rbgs_{t}"]
        assert args == _build.SIGNATURES[f"mg_stencil3d_residual_{t}"]


# ----------------------------------------------------------------------------
# The bfloat16 sweep's paired march (rbgs_pairs_kernel): words of two points
# ----------------------------------------------------------------------------

_NAN_WORD = np.uint32(0x7FC07FC0)     # two bfloat16 NaN: a dead ring slot


def _bits(a):
    """float32 values -> their bfloat16 bits (to nearest even), uint32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16).astype(np.uint32)


def _low(w):
    """A word's low bfloat16, widened (common.cuh's low_f)."""
    return (w.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _high(w):
    return (w.astype(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


class _WordRing(_Ring):
    """A ring of words whose slots start dead (NaN words)."""

    def __init__(self, z0, rows):
        super().__init__(z0)
        self.data = [np.full((rows, LANES), _NAN_WORD) for _ in range(SLOTS)]


def _pair_geometry(shape, chunk_of=None, chunk=None, mode="rbgs"):
    """march_geometry's paired ints for a (p, r, c) stack, of the RB-GS
    sweep or (mode "jacobi") the Jacobi one."""
    if chunk_of is not None:
        chunk_of(mode, shape, torch.bfloat16, chunk)
    return stencil3d.march_geometry("rbgs" if mode == "rbgs" else "pass",
                                    *shape, torch.bfloat16, paired=True)


def _emulate_pairs(geom, u16, b16, n, h, sigma, goff, roff, f32_out):
    """rbgs_pairs_kernel on the (p, r, c) stacks u16, b16 of bfloat16 bits:
    every load an aligned 32-bit word of the flat array (asserted even and
    in it), the rings of words, the shuffles' edge lanes reading NaN, the
    arithmetic in float32 in the kernel's order; returns (out as float32,
    writes a point). Constants as _emulate_rbgs takes them."""
    p, r, c = u16.shape
    strips, bands, chunks, width, chunk = geom
    R, H, owned = stencil3d.MARCH_PAIR_ROWS, 2, stencil3d.MARCH_PAIR_WORDS
    NU, NR = R + 2 * H, R + 2
    assert width == 2 * owned and chunk % 2 == 0
    flat = {"u": u16.reshape(-1), "b": b16.reshape(-1)}
    total = p * r * c
    h2 = np.float32(h * h)
    inv_den = np.float32(1.0 / (6.0 - sigma * h * h))
    out = np.full(total, np.nan, dtype=np.float32)
    writes = np.zeros(total, dtype=int)
    wlast = (c - 1) // 2
    lane = np.arange(LANES)
    nan = np.float32(np.nan)

    def left(v):          # __shfl_up_sync: lane 0 reads NaN
        o = np.roll(v, 1, axis=-1)
        o[..., 0] = nan
        return o

    def right(v):         # __shfl_down_sync: lane 31 reads NaN
        o = np.roll(v, -1, axis=-1)
        o[..., -1] = nan
        return o

    for unit in range(strips * bands * chunks):
        sx, sy, sz = (unit % strips, unit // strips % bands,
                      unit // (strips * bands))
        w = sx * owned - 1 + lane
        y0, z0 = sy * R, sz * chunk
        z1 = min(z0 + chunk, p)
        first, last = w == 0, w == wlast
        col = (w >= 0) & (w <= wlast)
        j = np.arange(NU)
        y = y0 - H + j
        rows = col[None, :] & ((y >= 0) & (y < r))[:, None]
        tail = last[None, :] & (y == r - 1)[:, None]
        yok = ((y >= 1) & (y <= r - 2) & (y + roff >= 1)
               & (y + roff <= n))[:, None]
        lo_in = [(2 * w - sh >= 1) & (2 * w - sh <= n) for sh in (0, 1)]
        hi_in = [(2 * w + 1 - sh >= 1) & (2 * w + 1 - sh <= n)
                 for sh in (0, 1)]
        shj = lambda sp: (sp + j) % 2          # noqa: E731  s of row j
        red_upd = [yok & np.where(shj(sp)[:, None] == 0, lo_in[0], lo_in[1])
                   for sp in (0, 1)]
        black_upd = [yok & np.where(shj(sp)[:, None] == 0, hi_in[0],
                                    hi_in[1]) for sp in (0, 1)]
        mine = (((lane >= 1) & (lane <= LANES - 2) & col)[None, :]
                & ((j >= H) & (j < H + R) & (y < r))[:, None])
        bmask = rows & (lane >= 1)[None, :]

        def valid(q):
            return 1 <= q <= p - 2 and 1 <= q + goff <= n

        def load(name, q, qend, j0, count, mask):
            v = np.zeros((count, LANES), dtype=np.uint32)
            if not 0 <= q < min(qend, p):
                return v
            if q == p - 1:
                mask = mask & ~tail
            sp = (q - z0) % 2                     # the slot's parity
            a = flat[name]
            for i in range(count):
                sh = (sp + j0 + i) % 2
                sel = mask[j0 + i]
                e = (q * r + y0 - H + j0 + i) * c + 2 * w[sel] - sh
                assert np.all(e % 2 == 0) and np.all(e >= 0) \
                    and np.all(e + 1 < total), (q, j0 + i, e)
                v[i, sel] = a[e] | (a[e + 1] << np.uint32(16))
            return v

        U, B, Rr = _WordRing(z0, NU), _WordRing(z0, NR), _WordRing(z0, NR)

        def load_u(q):
            U.put(q, load("u", q, z1 + 2, 0, NU, rows))

        def load_b(q):
            B.put(q, load("b", q, z1 + 1, 1, NR, bmask))

        def red(q):
            sp = (q - z0) % 2
            lo, mid, hi = U.get(q - 1), U.get(q), U.get(q + 1)
            cur = mid[1:-1]
            rgt = _high(cur)
            vert = ((_high(lo[1:-1]) + _high(hi[1:-1])) + _high(mid[:-2])) \
                + _high(mid[2:])
            s_row = ((sp + np.arange(NR) + 1) % 2)[:, None]
            total_ = np.where(s_row == 0, (vert + left(rgt)) + rgt,
                              left(vert + rgt) + rgt)
            gs = (h2 * _low(B.get(q)) + total_) * inv_den
            upd = red_upd[sp][1:-1] if valid(q) else np.zeros_like(cur, bool)
            Rr.put(q, np.where(upd, (cur & np.uint32(0xFFFF0000)) | _bits(gs),
                               cur))

        def black(q):
            sp = (q - z0) % 2
            lo, mid, hi = Rr.get(q - 1), Rr.get(q), Rr.get(q + 1)
            cur = mid[1:-1]
            lft = _low(cur)
            rgt = right(lft)
            vert = ((_low(lo[1:-1]) + _low(hi[1:-1])) + _low(mid[:-2])) \
                + _low(mid[2:])
            s_row = ((sp + np.arange(R)) % 2)[:, None]
            total_ = (np.where(s_row == 0, right(vert), vert) + lft) + rgt
            gs = (h2 * _high(B.get(q)[1:-1]) + total_) * inv_den
            upd = black_upd[sp][H:H + R] if valid(q) else False
            vhi = np.where(upd, gs, _high(cur))
            vlo = lft
            if not valid(q):
                vhi, vlo = np.zeros_like(vhi), np.zeros_like(vlo)
            if not f32_out:                       # pack_bf16: one rounding
                vhi, vlo = _high(_bits(vhi) << 16), _low(_bits(vlo))
            for i in range(R):
                own = mine[H + i]
                if not own.any():
                    continue
                sh = (sp + i) % 2
                e = (q * r + y0 + i) * c + 2 * w[own] - sh
                assert np.all(e % 2 == 0)
                lo_only = (sh == 0) & last[own]
                hi_only = (sh == 1) & first[own]
                for off, vals, keep in ((0, vlo[i, own], ~hi_only),
                                        (1, vhi[i, own], ~lo_only)):
                    out[e[keep] + off] = vals[keep]
                    writes[e[keep] + off] += 1

        for q in (z0 - 2, z0 - 1, z0, z0 + 1):
            load_u(q)
        load_b(z0 - 1)
        load_b(z0)
        red(z0 - 1)
        load_u(z0 + 2)
        load_b(z0 + 1)
        red(z0)
        for _, z in _steps(z0, z1):
            load_u(z + 3)
            load_b(z + 2)
            red(z + 1)
            black(z)
    return out.reshape(p, r, c), writes.reshape(p, r, c)


def _bf16_stack(n, goff, roff, p, r, seed, ghosts=True, spread=0):
    """A bfloat16 stack (as float32 values, and as bits) of a random grid;
    with ``ghosts`` its ghost points are random too (the sweep keeps u
    there); with ``spread`` each u scaled by 2^k, k uniform in [-spread,
    spread] (a sum of a few bfloat16 values of like size is exact in
    float32, whatever its order: spread values make the order show)."""
    u, b = _stack(n, goff, roff, p, r, seed)
    if ghosts:
        rng = np.random.default_rng(seed + 1)
        u = np.where(u == 0.0, rng.standard_normal(u.shape), u)
    if spread:
        rng = np.random.default_rng(seed + 2)
        u = u * np.exp2(rng.integers(-spread, spread + 1, u.shape))
    u, b = _bf16(u), _bf16(b)
    return u, b, _bits(u).astype(np.uint16), _bits(b).astype(np.uint16)


def _pair_case(n, goff, roff, p, r, chunk, sigma, f32_out, chunk_of,
               seed=3):
    u, b, u16, b16 = _bf16_stack(n, goff, roff, p, r, seed)
    ut, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, b))
    assert stencil3d.rbgs_pairs(ut, bt, torch.empty_like(
        ut, dtype=torch.float32 if f32_out else torch.bfloat16), goff, roff)
    geom = _pair_geometry((p, r, n + 2), chunk_of, chunk)
    h = 1.0 / (n + 1)
    got, writes = _emulate_pairs(geom, u16, b16, n, h, sigma, goff, roff,
                                 f32_out)
    assert (writes == 1).all()
    # Bit for bit the scalar march's schedule on the same values ...
    g = chunk_of("rbgs", (p, r, n + 2), torch.bfloat16, chunk)
    scalar, _ = _emulate_rbgs(g, u, b, n, h, sigma, goff, roff,
                              red_store=_bf16,
                              out_store=_keep if f32_out else _bf16)
    np.testing.assert_array_equal(got, scalar)
    # ... and the plain version by the bfloat16 rule.
    want = stencil3d.rbgs_sweep_plain(
        ut, bt, n, h, sigma=sigma, goff=goff, roff=roff,
        out_dtype=torch.float32 if f32_out else None)
    assert _bf16_rule_share(got, want.double().numpy()) <= 1e-3


@pytest.mark.parametrize("f32_out", [False, True])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_paired_march_matches_scalar_and_plain(sigma, f32_out, chunk_of):
    """The paired march on a whole 65^3 grid (p odd: the last row of the
    last plane ends on a straddling word), two strips of 30 owned words
    (the second 3), chunks of 8 planes (the last one plane): every point
    written once, bit for bit the scalar march's float32 order on the
    same bfloat16 values, and the plain version by the bfloat16 rule."""
    _pair_case(63, 0, 0, 65, 65, 8, sigma, f32_out, chunk_of)


@pytest.mark.parametrize("n,goff,roff,p,r,chunk", [
    (63, 5, -1, 21, 33, 6), (31, 1, 1, 9, 35, 4), (63, -1, 3, 12, 17, 128)])
def test_paired_march_on_offset_stacks(n, goff, roff, p, r, chunk,
                                       chunk_of):
    """Stacks whose offsets sum to an even number pair too: planes and
    rows past the grid, a chunk of one step, p even and odd."""
    _pair_case(n, goff, roff, p, r, chunk, SIGMA, False, chunk_of)


def test_odd_offset_stack_takes_the_scalar_march(chunk_of):
    """A stack with goff + roff odd (chip_smoke's MIXED3D_STACK kind), or r
    or c even, does not pair: rbgs_pairs says so (the launcher's rule),
    and the scalar march, which the launcher runs there, holds against
    the plain version by the bfloat16 rule."""
    n, goff, roff, p, r = 31, 3, 0, 12, 17
    u, b, _, _ = _bf16_stack(n, goff, roff, p, r, seed=8)
    ut, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, b))
    assert not stencil3d.rbgs_pairs(ut, bt, torch.empty_like(ut), goff, roff)
    even = torch.zeros((5, 6, 33), dtype=torch.bfloat16)
    assert not stencil3d.rbgs_pairs(even, even, even)
    even = torch.zeros((5, 7, 34), dtype=torch.bfloat16)
    assert not stencil3d.rbgs_pairs(even, even, even)
    whole = torch.zeros((5, 7, 33), dtype=torch.bfloat16)
    assert stencil3d.rbgs_pairs(whole, whole, whole)
    shifted = torch.zeros(5 * 7 * 33 + 1, dtype=torch.bfloat16)[1:]
    assert not stencil3d.rbgs_pairs(whole, whole, shifted.view(5, 7, 33))
    g = chunk_of("rbgs", (p, r, n + 2), torch.bfloat16, 4)
    h = 1.0 / (n + 1)
    got, writes = _emulate_rbgs(g, u, b, n, h, SIGMA, goff, roff,
                                red_store=_bf16, out_store=_bf16)
    assert (writes == 1).all()
    want = stencil3d.rbgs_sweep_plain(ut, bt, n, h, sigma=SIGMA, goff=goff,
                                      roff=roff)
    assert _bf16_rule_share(got, want.double().numpy()) <= 1e-3


@pytest.mark.parametrize("shape", _GEOMETRY_SHAPES + [(3, 3, 5), (4, 9, 7)])
def test_paired_geometry_owns_each_word_once(shape):
    """The paired geometry: every word index of a row ((c + 1) // 2 of
    them) in one strip's owned words, every row in one band, every plane
    in one chunk, each non-empty (the kernel's pair_geom_fits); chunks
    even, at most MARCH_CHUNK's rounded up."""
    p, r, c = shape
    strips, bands, chunks, width, chunk = _pair_geometry(shape)
    owned, rows = stencil3d.MARCH_PAIR_WORDS, stencil3d.MARCH_PAIR_ROWS
    words = (c + 1) // 2
    assert width == 2 * owned and chunk % 2 == 0 and chunk >= 2
    for count, size, part in ((strips, words, owned), (bands, r, rows),
                              (chunks, p, chunk)):
        assert count * part >= size and (count - 1) * part < size
    assert chunk <= stencil3d.MARCH_CHUNK["rbgs"] + 1


def test_pair_constants_match_the_kernel_source():
    """MARCH_PAIR_ROWS and MARCH_PAIR_WORDS are csrc/stencil3d.cuh's
    kPairRows (both paired marches' bands) and kLanes - 2; the bands start
    on even rows."""
    src = (_build.CSRC / "stencil3d.cuh").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kPairRows"] == stencil3d.MARCH_PAIR_ROWS
    assert stencil3d.MARCH_PAIR_ROWS % 2 == 0
    assert const["kLanes"] - 2 == stencil3d.MARCH_PAIR_WORDS
    assert "const int owned = kLanes - 2;" in src


# ----------------------------------------------------------------------------
# The bfloat16 Jacobi sweep's paired march (jacobi_pairs_kernel)
# ----------------------------------------------------------------------------

def _emulate_jacobi_pairs(geom, u16, b16, n, h, sigma, goff, roff):
    """jacobi_pairs_kernel on the (p, r, c) stacks u16, b16 of bfloat16
    bits, as _emulate_pairs emulates rbgs_pairs_kernel: every load an
    aligned 32-bit word of the flat array (asserted even and in it), the
    rings of words with dead slots NaN, the shuffles' edge lanes reading
    NaN, a row's s from its plane's slot and its region row (PairUnit's
    row_s: the plane's parity counts only where r is odd), the partial sums
    formed on the other lane and shuffled, each output word rounded once;
    the arithmetic in float32 with _emulate_pass's constants. Returns (out
    as float32, writes a point, the outputs before their rounding)."""
    p, r, c = u16.shape
    strips, bands, chunks, width, chunk = geom
    R, H = stencil3d.MARCH_PAIR_ROWS, 1
    owned = stencil3d.MARCH_PAIR_WORDS
    NU = R + 2 * H
    assert width == 2 * owned and chunk % 2 == 0
    flat = {"u": u16.reshape(-1), "b": b16.reshape(-1)}
    total = p * r * c
    inv_h2 = 1.0 / (h * h)
    jscale = OMEGA / (6.0 * inv_h2 - sigma)
    out = np.full(total, np.nan, dtype=np.float32)
    unrounded = out.copy()
    writes = np.zeros(total, dtype=int)
    wlast = (c - 1) // 2
    lane = np.arange(LANES)
    r_odd = r % 2 == 1

    def row_s(sp, j):
        return ((sp if r_odd else 0) + H + j) % 2

    def point(cur, total_, bv, upd):
        res = bv - (6.0 * cur - total_) * inv_h2 + sigma * cur
        return np.where(upd, cur + jscale * res, cur)

    for unit in range(strips * bands * chunks):
        sx, sy, sz = (unit % strips, unit // strips % bands,
                      unit // (strips * bands))
        w = sx * owned - 1 + lane
        y0, z0 = sy * R, sz * chunk
        z1 = min(z0 + chunk, p)
        first, last = w == 0, w == wlast
        col = (w >= 0) & (w <= wlast)
        j = np.arange(NU)
        y = y0 - H + j
        rows = col[None, :] & ((y >= 0) & (y < r))[:, None]
        tail = last[None, :] & (y == r - 1)[:, None]
        yok = ((y >= 1) & (y <= r - 2) & (y + roff >= 1)
               & (y + roff <= n))[:, None]
        lo_in = [(2 * w - sh >= 1) & (2 * w - sh <= n) for sh in (0, 1)]
        hi_in = [(2 * w + 1 - sh >= 1) & (2 * w + 1 - sh <= n)
                 for sh in (0, 1)]
        lo_upd = [yok & np.where(row_s(sp, j)[:, None] == 0, lo_in[0],
                                 lo_in[1]) for sp in (0, 1)]
        hi_upd = [yok & np.where(row_s(sp, j)[:, None] == 0, hi_in[0],
                                 hi_in[1]) for sp in (0, 1)]
        mine = (((lane >= 1) & (lane <= LANES - 2) & col)[None, :]
                & ((j >= H) & (j < H + R) & (y < r))[:, None])

        def load(name, q, qend, j0, count, mask):
            v = np.zeros((count, LANES), dtype=np.uint32)
            if not 0 <= q < min(qend, p):
                return v
            if q == p - 1:
                mask = mask & ~tail
            sp = (q - z0) % 2                     # the slot's parity
            a = flat[name]
            for i in range(count):
                sh = row_s(sp, j0 + i)
                sel = mask[j0 + i]
                e = (q * r + y0 - H + j0 + i) * c + 2 * w[sel] - sh
                assert np.all(e % 2 == 0) and np.all(e >= 0) \
                    and np.all(e + 1 < total), (q, j0 + i, e)
                v[i, sel] = a[e] | (a[e + 1] << np.uint32(16))
            return v

        U, B = _WordRing(z0, NU), _WordRing(z0, R)

        def load_u(q):
            U.put(q, load("u", q, z1 + 1, 0, NU, rows))

        def load_b(q):
            B.put(q, load("b", q, z1, H, R, mine))

        def apply(q):
            sp = (q - z0) % 2
            below, mid, above = U.get(q - 1), U.get(q), U.get(q + 1)
            cur, zm, zp = mid[1:-1], below[1:-1], above[1:-1]
            ym, yp = mid[:-2], mid[2:]
            clo, chi = _low(cur), _high(cur)
            s0 = (row_s(sp, np.arange(R) + H) == 0)[:, None]
            if r_odd:
                vhi = ((_high(zm) + _high(zp)) + _high(ym)) + _high(yp)
                vlo = ((_low(zm) + _low(zp)) + _low(ym)) + _low(yp)
                slo = np.where(s0, (vhi + _left(chi)) + chi,
                               _left(vhi + chi) + chi)
                shi = np.where(s0, (_right(vlo) + clo) + _right(clo),
                               (vlo + clo) + _right(clo))
            else:
                zlo, zhi = _low(zm) + _low(zp), _high(zm) + _high(zp)
                slo = np.where(
                    s0, (((zlo + _high(ym)) + _high(yp)) + _left(chi)) + chi,
                    _left(((_right(zlo) + _high(ym)) + _high(yp)) + chi)
                    + chi)
                shi = np.where(
                    s0, (_right((_left(zhi) + _low(ym)) + _low(yp)) + clo)
                    + _right(clo),
                    (((zhi + _low(ym)) + _low(yp)) + clo) + _right(clo))
            bw = B.get(q)
            if 1 <= q <= p - 2 and 1 <= q + goff <= n:
                vlo = point(clo, slo, _low(bw), lo_upd[sp][1:-1])
                vhi = point(chi, shi, _high(bw), hi_upd[sp][1:-1])
            else:
                vlo, vhi = np.zeros_like(clo), np.zeros_like(chi)
            wide = {0: vlo, 1: vhi}
            vhi, vlo = _high(_bits(vhi) << 16), _low(_bits(vlo))
            for i in range(R):
                own = mine[H + i]
                if not own.any():
                    continue
                sh = row_s(sp, H + i)
                e = (q * r + y0 + i) * c + 2 * w[own] - sh
                assert np.all(e % 2 == 0)
                lo_only = (sh == 0) & last[own]
                hi_only = (sh == 1) & first[own]
                for off, vals, keep in ((0, vlo[i, own], ~hi_only),
                                        (1, vhi[i, own], ~lo_only)):
                    out[e[keep] + off] = vals[keep]
                    unrounded[e[keep] + off] = wide[off][i, own][keep]
                    writes[e[keep] + off] += 1

        for q in (z0 - 1, z0, z0 + 1):
            load_u(q)
        load_b(z0)
        for _, z in _steps(z0, z1):
            load_u(z + 2)
            load_b(z + 1)
            apply(z)
    return (out.reshape(p, r, c), writes.reshape(p, r, c),
            unrounded.reshape(p, r, c))


def _jacobi_pair_case(n, goff, roff, p, r, chunk, sigma, sweeps, chunk_of,
                      seed=4):
    """``sweeps`` chained paired Jacobi sweeps on a random bfloat16 stack
    (u spread over 25 binades, so that a sum in another order would part):
    each every point written once and bit for bit the scalar march's
    bfloat16 emulation on the same values, before the output's rounding
    (the float32-storing mode's emulation: the rounding to bfloat16 hides
    most float32 differences) and after it; the last against the plain
    version of one sweep from its own input by the bfloat16 rule."""
    u, b, u16, b16 = _bf16_stack(n, goff, roff, p, r, seed, spread=12)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    shape = (p, r, n + 2)
    h = 1.0 / (n + 1)
    geom = _pair_geometry(shape, chunk_of, chunk, mode="jacobi")
    g = chunk_of("jacobi", shape, torch.bfloat16, chunk)
    for _ in range(sweeps):
        start = torch.from_numpy(u).to(torch.bfloat16)
        assert stencil3d.jacobi_pairs(start, bt, torch.empty_like(start))
        got, writes, wide = _emulate_jacobi_pairs(geom, u16, b16, n, h,
                                                  sigma, goff, roff)
        assert (writes == 1).all()
        scalar = _emulate_bf16("jacobi", g, u, b, n, h, 1, F32,
                               sigma=sigma, goff=goff, roff=roff)
        np.testing.assert_array_equal(wide, scalar)
        np.testing.assert_array_equal(got, _bf16(scalar))
        u, u16 = got, _bits(got).astype(np.uint16)
    want = stencil3d.jacobi_sweep_plain(start, bt, n, h, OMEGA, sigma=sigma,
                                        goff=goff, roff=roff)
    assert want.dtype == torch.bfloat16
    assert _bf16_rule_share(got, want.double().numpy()) <= 1e-3


# (n, goff, roff, p, r, chunk, sigma, sweeps): a whole 65^3 grid (r odd,
# chunks of 8 with a last one of 1 plane, the last row of the last plane
# ending on a straddling word); a pencil-shaped stack (r even, planes and
# rows past both ends of the grid: hz = 2 at n = 31); goff + roff odd,
# which pairs for Jacobi but not for RB-GS, with r = 17 one past a band; c
# = 61 = 2 * 30 + 1 (a second strip of one word) with r = 17 and chunks 6,
# 6, 6, 2; two chained sweeps on a 33^3 grid.
_JACOBI_PAIR_CASES = [(63, 0, 0, 65, 65, 8, SIGMA, 1),
                      (31, -2, -2, 38, 38, 6, SIGMA, 1),
                      (31, 3, 0, 12, 17, 4, 0.0, 1),
                      (59, 20, 10, 20, 17, 6, 0.0, 1),
                      (31, 0, 0, 33, 33, 8, 0.0, 2)]


@pytest.mark.parametrize("n,goff,roff,p,r,chunk,sigma,sweeps",
                         _JACOBI_PAIR_CASES)
def test_paired_jacobi_matches_scalar_and_plain(n, goff, roff, p, r, chunk,
                                                sigma, sweeps, chunk_of):
    _jacobi_pair_case(n, goff, roff, p, r, chunk, sigma, sweeps, chunk_of)


def test_jacobi_pairs_rule_and_the_scalar_march(chunk_of):
    """jacobi_pairs (the launcher's rule): bfloat16 u, b and out, c odd and
    each array on a 4-byte word, whatever r and the offsets; an odd
    pointer, c even or a float32 output do not pair, and the scalar march,
    which the launcher runs there, holds against the plain version by the
    bfloat16 rule."""
    bf = torch.bfloat16
    whole = torch.zeros((5, 7, 33), dtype=bf)
    assert stencil3d.jacobi_pairs(whole, whole, whole)
    even_r = torch.zeros((5, 6, 33), dtype=bf)
    assert stencil3d.jacobi_pairs(even_r, even_r, even_r)
    even_c = torch.zeros((5, 7, 34), dtype=bf)
    assert not stencil3d.jacobi_pairs(even_c, even_c, even_c)
    assert not stencil3d.jacobi_pairs(whole, whole,
                                      torch.empty_like(whole, dtype=F32))
    shifted = torch.zeros(5 * 7 * 33 + 1, dtype=bf)[1:].view(5, 7, 33)
    for args in ((shifted, whole, whole), (whole, shifted, whole),
                 (whole, whole, shifted)):
        assert not stencil3d.jacobi_pairs(*args)
    n, goff, roff, p, r = 31, 3, 0, 12, 17
    u, b, _, _ = _bf16_stack(n, goff, roff, p, r, seed=9)
    g = chunk_of("jacobi", (p, r, n + 2), bf, 4)
    h = 1.0 / (n + 1)
    got = _emulate_bf16("jacobi", g, u, b, n, h, 1, None, goff=goff,
                        roff=roff)
    want = stencil3d.jacobi_sweep_plain(
        *(torch.from_numpy(a).to(bf) for a in (u, b)), n, h, OMEGA,
        sigma=SIGMA, goff=goff, roff=roff)
    assert _bf16_rule_share(got, want.double().numpy()) <= 1e-3


@pytest.mark.parametrize("shape", _GEOMETRY_SHAPES + [(3, 3, 5), (4, 9, 7),
                                                      (518, 518, 513)])
def test_paired_jacobi_geometry_owns_each_word_once(shape):
    """The paired Jacobi geometry: every word index of a row in one
    strip's owned words, every row in one band of MARCH_PAIR_ROWS,
    every plane in one chunk, each non-empty (the kernel's pair_geom_fits
    with kPairRows); chunks even, at most MARCH_CHUNK's rounded up."""
    p, r, c = shape
    strips, bands, chunks, width, chunk = _pair_geometry(shape, mode="jacobi")
    owned, rows = stencil3d.MARCH_PAIR_WORDS, stencil3d.MARCH_PAIR_ROWS
    words = (c + 1) // 2
    assert width == 2 * owned and chunk % 2 == 0 and chunk >= 2
    for count, size, part in ((strips, words, owned), (bands, r, rows),
                              (chunks, p, chunk)):
        assert count * part >= size and (count - 1) * part < size
    assert chunk <= stencil3d.MARCH_CHUNK["pass"] + 1
    with pytest.raises(ValueError):
        stencil3d.march_geometry("pass", *shape, F32, paired=True)


def test_jacobi_sweep_launches_the_paired_march(monkeypatch):
    """On a CUDA tensor (the device rule faked, the launches recorded) a
    bfloat16 Jacobi call takes the paired geometry and counts
    jacobi_bf16_pairs_launches on every sweep that stores bfloat16, the
    scalar geometry on the last one with out_dtype=float32; the RB-GS
    sweeps' pair count stays."""
    calls = []
    monkeypatch.setattr(stencil3d, "on_cuda", lambda t: True)
    monkeypatch.setattr(stencil3d, "launch_on", lambda t, kernel, *args,
                        out_dtype=None, writes=(): calls.append(
                            (kernel, tuple(args[-1]), out_dtype)))
    for name in ("jacobi_bf16_launches", "jacobi_bf16_f32_launches",
                 "jacobi_bf16_pairs_launches", "rbgs_bf16_pairs_launches"):
        monkeypatch.setattr(stencil3d, name, 0)
    n, shape = 31, (38, 38, 33)                 # r even: the pencil's kind
    u = torch.zeros(shape, dtype=torch.bfloat16)
    stencil3d.jacobi_sweep(u, u, n, 1.0 / 32, OMEGA, sweeps=3, goff=-2,
                           roff=-2, out_dtype=F32)
    bf = torch.bfloat16
    paired = stencil3d.march_geometry("pass", *shape, bf, paired=True)
    scalar = stencil3d.march_geometry("pass", *shape, bf)
    assert calls == [("stencil3d_jacobi", paired, bf)] * 2 + [
        ("stencil3d_jacobi", scalar, F32)]
    assert (stencil3d.jacobi_bf16_launches, stencil3d.jacobi_bf16_f32_launches,
            stencil3d.jacobi_bf16_pairs_launches,
            stencil3d.rbgs_bf16_pairs_launches) == (2, 1, 2, 0)
