"""The port's communication audit (multigridcmt_tpu_torch/utils/
comm_audit.py) on gloo worlds (rows of 4, a 2x2 block), against JAX's
``comm_audit.audit`` of the same config on the conftest's virtual devices,
as tests/test_comm_audit.py derives it.

Derivations (one "pair" = a near and a far slab along one mesh axis; JAX
counts each slab as one ppermute, the port's audit counts the same unit):

* Whole-leg path, L leg levels (k=8, KERNEL_MIN_N = 30, L = 4): the cycle
  entry extends x and b (2 pairs), each leg level refreshes before its up
  leg (L pairs), each leg-to-leg crossing refreshes the coarse RHS and the
  correction (2(L - 1) pairs): 3L pairs, and one all_gather per mesh axis
  at the agglomeration crossing.
* Tile-stencil path (k=6, S sharded levels, RB-GS nu = 2): each half-sweep
  exchanges both slabs (2), the residual 2, the restriction the far slab
  (1), the prolongation the near one (1), the last sharded level's
  correction is the agglomeration gather: S(8 nu + 3) + (S - 1) per axis.

Counts equal JAX's. Bytes: on the tile-stencil path the tiles are the
same on both sides and the bytes equal JAX's; on the whole-leg path JAX's
extended tiles are padded to TPU alignment (rows to 16, lanes to 128) and
the port's keep their logical extent, so the port's bytes are held to its
own derivation from its tile shapes (``_leg_bytes``). A rank with both
neighbours on every axis (rows 1 and 2 of 4) sends every slab it offers:
its messages and bytes sent equal the ppermute counts and bytes.

F2 (ROADMAP.md, queue 3): JAX walks the jaxpr, so v_cycles_fn's loop body
counts once for any m; the port counts per execution: m chained cycles on
the tile path are m times one cycle, and on the whole-leg path one cycle
(the entry and the first cycle, v_cycle_fn's count) plus (m - 1) times
JAX's loop body (a ghost refresh and a cycle from extended tiles).
"""
import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.kernels import local2d
from test_torch_sharded import KERNEL_MIN_N, _jax_mesh, spawn_world

CHAIN = 3
WORLDS = {"rows4": (4,), "block2x2": (2, 2)}
# agglom_rows giving L = 4 leg levels at k=8 on each mesh (JAX's test).
LEG_AGGLOM = {(4,): 8, (2, 2): 16}
CASES = {"leg": dict(k=8, use_kernels=True), "tile": dict(k=6, agglom=8)}


def _config(shape, name):
    kw = CASES[name]
    return dict(ndim=2, k=kw["k"], smoother="rbgs",
                use_kernels=kw.get("use_kernels", False),
                agglom_rows=kw.get("agglom", LEG_AGGLOM[shape]))


def _audit_case(mesh, kw, b):
    """One rank: a v_cycle_fn cycle and CHAIN chained v_cycles_fn cycles
    under the port's audit, with the route's level counts."""
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.comm_audit import comm_audit

    cfg = SolverConfig(dtype=torch.float64, **kw["config"])
    s = sharded.ShardedSolver(cfg, mesh)
    bt = sharded.shard_rhs(b, mesh, s.decomp)
    with comm_audit() as one:
        s.v_cycle_fn()(torch.zeros_like(bt), bt)
    with comm_audit() as chain:
        s.v_cycles_fn()(torch.zeros_like(bt), bt, CHAIN)
    lev = legs = 0
    while sharded._leg_level_ok(cfg, s.decomp, legs):
        legs += 1
    while sharded._is_sharded(cfg, s.decomp, lev):
        lev += 1
    return {"one": one.report(), "chain": chain.report(), "legs": legs,
            "sharded": lev, "coords": mesh.coords}


def _jax_audits(shape):
    """JAX's audit of each case: one cycle, and v_cycles_fn at m = 1 and
    m = CHAIN."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded
    from multigridcmt_tpu.utils import comm_audit as jaudit

    out = {}
    mesh = _jax_mesh(shape)
    for name in CASES:
        cfg = JConfig(dtype=jnp.float64, use_pallas=CASES[name].get(
            "use_kernels", False), **{k: v for k, v in _config(
                shape, name).items() if k != "use_kernels"})
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
            s = jsharded.ShardedSolver(cfg, mesh)
            b = jsharded.shard_rhs(jnp.zeros((cfg.n + 2,) * 2, jnp.float64),
                                   mesh, s.decomp)
            x = jnp.zeros_like(b)
            out[name] = {"one": jaudit.audit(s.v_cycle_fn(), x, b)}
            for m in (1, CHAIN):
                out[name][m] = jaudit.audit(s.v_cycles_fn(), x, b, m)
    return out


@pytest.fixture(scope="module")
def worlds():
    cache = {}

    def get(world):
        if world not in cache:
            shape = WORLDS[world]
            cases = {name: {"config": _config(shape, name)}
                     for name in CASES}
            inputs = {name: np.random.default_rng(5).standard_normal(
                (2 ** CASES[name]["k"] + 1,) * 2) for name in CASES}
            cache[world] = spawn_world(shape, cases, inputs,
                                       lambda: _jax_audits(shape),
                                       run_case=_audit_case)
        return cache[world]

    return get


def _leg_bytes(k, shape, legs, hh=local2d.HALO_ROWS, item=8):
    """The port's ppermute bytes of one whole-leg cycle: 3 pairs a leg
    level, the entry's two extensions and the refreshes at their tiles'
    logical extents (rows: hh x (n + 2) slabs; blocks: hh x mcol slabs for
    the entry's first axis, hh x (mcol + 2 hh) and (m + 2 hh) x hh
    slabs after it)."""
    total = 0
    for lev in range(legs):
        n = 2 ** (k - lev) - 1
        m = 2 ** (k - lev) // shape[0]
        if len(shape) == 1:
            total += 3 * 2 * hh * (n + 2)
            continue
        mcol = 2 ** (k - lev) // shape[1]
        refresh = 2 * hh * (mcol + 2 * hh) + 2 * (m + 2 * hh) * hh
        extend = 2 * hh * mcol + 2 * (m + 2 * hh) * hh
        total += (2 * extend + refresh) if lev == 0 else 3 * refresh
    return total * item


def _gather_bytes(k, shape, level, item=8):
    """all_gather operand bytes at the agglomeration crossing into
    ``level``: the owned coarse tile, then (blocks) its row-gathered
    stack."""
    rows = 2 ** (k - level)
    if len(shape) == 1:
        return rows // shape[0] * (rows + 1) * item
    tile = (rows // shape[0]) * (rows // shape[1])
    return (tile + tile * shape[0]) * item


@pytest.mark.parametrize("world", list(WORLDS))
def test_leg_path_counts_match_jax(world, worlds):
    """Whole-leg path: 3L pairs a mesh axis, one all_gather per axis, as
    JAX's audit counts; the port's bytes from its own tile shapes."""
    shape = WORLDS[world]
    ranks, refs = worlds(world)
    naxes = len(shape)
    want = refs["leg"]["one"]
    k = CASES["leg"]["k"]
    for got in ranks:
        rep = got["leg"]["one"]
        legs = got["leg"]["legs"]
        assert legs == 4
        assert rep["counts"] == {"ppermute": 2 * 3 * legs * naxes,
                                 "all_gather": naxes}
        assert rep["counts"] == want["counts"]
        assert rep["bytes"]["ppermute"] == _leg_bytes(k, shape, legs)
        assert rep["bytes"]["all_gather"] == want["bytes"]["all_gather"] \
            == _gather_bytes(k, shape, legs)
        assert "psum" not in rep["counts"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_tile_path_counts_and_bytes_match_jax(world, worlds):
    """Tile-stencil path: S(8 nu + 3) + (S - 1) ppermutes per axis and one
    all_gather per axis, counts and bytes equal to JAX's; a rank with both
    neighbours sends what it offers."""
    shape = WORLDS[world]
    ranks, refs = worlds(world)
    want = refs["tile"]["one"]
    for got in ranks:
        rep = got["tile"]["one"]
        s = got["tile"]["sharded"]
        assert rep["counts"]["ppermute"] == \
            len(shape) * (s * (8 * 2 + 3) + (s - 1))
        assert {k: rep[k] for k in ("counts", "bytes")} == want
        interior = all(0 < c < d - 1 for c, d in zip(got["coords"], shape))
        if interior:
            assert rep["sent"] == {"messages": rep["counts"]["ppermute"],
                                   "bytes": rep["bytes"]["ppermute"]}
        else:
            assert rep["sent"]["messages"] < rep["counts"]["ppermute"]
    if shape == (4,):
        assert sum(all(0 < c < 3 for c in g["coords"]) for g in ranks) == 2


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("path", ["tile", "leg"])
def test_chained_cycles_count_per_execution(world, path, worlds):
    """F2: JAX's audit counts v_cycles_fn's loop body once whatever m is;
    the port counts CHAIN chained cycles per execution."""
    shape = WORLDS[world]
    ranks, refs = worlds(world)
    jone, jm = refs[path][1], refs[path][CHAIN]
    for got in ranks:
        one, chain = got[path]["one"], got[path]["chain"]
        if path == "tile":
            # JAX's whole chain is its loop body: counted once.
            assert jm == jone == refs[path]["one"]
            for key in ("counts", "bytes"):
                assert chain[key] == {p: CHAIN * v
                                      for p, v in one[key].items()}
        else:
            # JAX traces the entry, the first cycle (v_cycle_fn's count)
            # and the loop body once, for any m.
            assert jm == jone
            first = refs[path]["one"]["counts"]
            body = {p: jm["counts"][p] - first[p] for p in first}
            assert all(v > 0 for v in body.values())
            assert chain["counts"] == {
                p: first[p] + (CHAIN - 1) * body[p] for p in first}
            assert one["counts"] == first
