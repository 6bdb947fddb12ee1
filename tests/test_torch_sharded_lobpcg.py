"""The port's sharded LOBPCG (ShardedSolver.eigensolve(method="lobpcg"),
parallel/sharded.py: _eigensolve_lobpcg) in gloo worlds of CPU processes,
held as tests/test_torch_sharded_eigen.py holds inverse iteration and RQI
(its ranks, references and checks): against JAX's sharded LOBPCG (Pallas in
interpret mode for rows2's lobpcg1, the plain sharded route elsewhere), the
port's single-device lobpcg, the exact spectrum and, with a bfloat16
preconditioner, the full-precision run; the preconditioner stays unpacked
when the fine level packs; and a start block that each rank computes
(rank 1's signs flipped) is broadcast from the first rank."""
import pytest

from test_torch_sharded_eigen import cases_of, check_case, world_getter

WORLDS = {
    "rows2": ((2,), {
        "lobpcg1": dict(k=6, method="lobpcg", block=1),
        "lobpcg2": dict(k=6, method="lobpcg", block=2, ref="jax-plain"),
        # The fine level packs, but the preconditioner's cycles do not.
        "packed-lobpcg": dict(k=8, method="lobpcg", block=1, pack=True,
                              ref="jax-plain"),
        "mixed-lobpcg": dict(k=6, method="lobpcg", block=1, ref="single",
                             mixed=True),
        # Checked against lobpcg1 of the same ranks.
        "coarse": dict(k=6, method="lobpcg", block=1, ref="single",
                       coarse=True),
    }),
    "block2x2": ((2, 2), {
        "lobpcg1": dict(k=6, method="lobpcg", block=1, ref="jax-plain"),
    }),
}


@pytest.fixture(scope="module")
def world_results():
    return world_getter(WORLDS)


@pytest.mark.parametrize("world,case", cases_of(WORLDS),
                         ids=[f"{w}-{c}" for w, c in cases_of(WORLDS)])
def test_sharded_lobpcg_matches_jax(world, case, world_results):
    ranks, refs = world_results(world)
    check_case(ranks, refs, WORLDS[world][1][case], case)
