"""A lane's result does not depend on where a batch puts it, on the CPU's
plain path: the sum over a lane-major tensor's rows (``ops/qp.lane_sum``),
the plain single-solve PDIP (``ops/kernels.pdip_fused_plain``) and solve
(``solve_lanes_plain``) on slices of a batch, and a float32 Shell3x3 VNS
objective batch of repeated candidates (its closed and open legs and F).
torch's own sum over the rows rounds the lanes of a whole group of 32
(float32) or 16 (float64) otherwise than the rest, so before ``lane_sum``
a lane's PDIP depended on its column on the CPU too.  The same checks on
the card's kernels are in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3
from mpc_tuning_tpu_torch.ops import kernels as K
from mpc_tuning_tpu_torch.ops.qp import lane_sum
from mpc_tuning_tpu_torch.tuning.api import build_problem
from mpc_tuning_tpu_torch.tuning.objectives import vns_objective_batch

torch.set_num_threads(1)  # small batches: threads only contend with workers

F32, F64 = torch.float32, torch.float64
SLICES = ((0, 37), (5, 18), (36, 37))  # as the card's tests cut a batch


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("rows", [1, 7, 181])
@pytest.mark.parametrize("batch_major", [False, True])
def test_lane_sum_does_not_depend_on_the_slot(rows, dtype, batch_major):
    """Lanes holding one column read one sum at every batch size, and a
    slice of a batch sums as the same lanes of the whole batch, lane-major
    and in the transposed batch-major layout of the open leg."""
    g = torch.Generator().manual_seed(rows)
    layout = ((lambda x: x.T.contiguous().T) if batch_major
              else (lambda x: x.contiguous()))
    total = lambda x: lane_sum(layout(x), batch_major)
    v = torch.randn((rows, 1), generator=g, dtype=dtype)
    ref = total(v)
    for B in (2, 8, 37, 57):
        assert torch.equal(total(v.expand(rows, B)), ref.expand(1, B))
    x = torch.randn((rows, 37), generator=g, dtype=dtype)
    whole = total(x)
    torch.testing.assert_close(whole, x.sum(0, keepdim=True))
    for lo, hi in SLICES:
        assert torch.equal(total(x[:, lo:hi]), whole[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("rows", [1, 7, 33, 181])
def test_warp_order_sum_is_the_kernels_order(rows, dtype):
    """``ops/kernels.warp_order_sum`` (the plain versions' row sum on the
    card) adds a lane's rows as warp_qp.cuh's warp_sum does: row r into
    partial r % 32 from zero, then the xor butterfly as lane 0 sees it;
    its bits follow neither the batch's width nor a lane's slot."""
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 37), generator=g, dtype=dtype)
    s = K.warp_order_sum(x)
    for b in (0, 11, 36):
        part = [torch.zeros((), dtype=dtype) for _ in range(32)]
        for r in range(rows):
            part[r % 32] = part[r % 32] + x[r, b]
        for o in (16, 8, 4, 2, 1):
            part = [part[i] + part[i + o] for i in range(o)]
        assert torch.equal(part[0], s[0, b]), b
    torch.testing.assert_close(s, x.sum(0, keepdim=True))
    for lo, hi in SLICES:
        assert torch.equal(K.warp_order_sum(x[:, lo:hi]), s[:, lo:hi])
    perm = torch.randperm(37, generator=g)
    assert torch.equal(K.warp_order_sum(x[:, perm]), s[:, perm])


def _step_qp(dtype, B=37, take=12, caps=(32, 4)):
    """The plain single-solve PDIP's arguments at step ``take`` of B seeded
    Shell3x3 candidates' closed loop (a real step's QPs and warm start)."""
    problem, _ = build_problem(shell3x3.make_case(nit=take + 1), device="cpu")
    rng = np.random.default_rng(0)
    N = rng.integers(caps[1] + 1, caps[0] + 1, size=B)
    Nu = rng.integers(2, caps[1] + 1, size=B)
    r_b = np.broadcast_to(problem.r, (B, take + 1, problem.my))
    t, lc, Hp, r_l, dims = problem.loop.sim_inputs(
        r_b, problem.v, N, Nu, rng.uniform(0.2, 2.0, (B, problem.my)),
        rng.uniform(0.05, 0.5, (B, problem.nu)), take + 1, dtype,
        "pdip_ws_fused", "cpu", caps=caps)
    G = K.g_shared(t["G0"], t["T2T"])
    seen = {}

    def qp(*args):
        seen["args"] = args
        return K.pdip_fused(*args)

    K.step_loop(t, lc, r_l, dims, *K.pdip_step(t, lc, Hp, dims, G, 15, qp))
    return seen["args"]


def _lanes(args, lo, hi):
    """The single solve's arguments of lanes lo ... hi - 1 alone."""
    cut = lambda x: x[..., lo:hi].contiguous()
    Hp, f, h, rmask, cmask, warm, G, iters = args
    return (cut(Hp), cut(f), cut(h), cut(rmask), cut(cmask),
            tuple(map(cut, warm)), G, iters)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_pdip_plain_does_not_depend_on_the_slot(dtype):
    """The plain single-solve PDIP of a slice of a batch gives the same
    (z, lam, s) bits as the same lanes of the whole batch."""
    args = _step_qp(dtype)
    whole = K.pdip_fused(*_lanes(args, 0, 37))
    for lo, hi in SLICES:
        part = K.pdip_fused(*_lanes(args, lo, hi))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_solve_lanes_plain_does_not_depend_on_the_slot(dtype):
    g = torch.Generator().manual_seed(17)
    A = torch.randn((37, 17, 17), generator=g, dtype=dtype)
    M = (A @ A.transpose(1, 2) + 17 * torch.eye(17, dtype=dtype))
    L = K.factor_lanes(M.permute(1, 2, 0).contiguous()).contiguous()
    rhs = torch.randn((17, 37), generator=g, dtype=dtype)
    whole = K.solve_lanes(L, rhs)
    for lo, hi in SLICES:
        assert torch.equal(K.solve_lanes(L[..., lo:hi].contiguous(),
                                         rhs[:, lo:hi].contiguous()),
                           whole[:, lo:hi]), (lo, hi)


# (N, max Nu) per candidate: one candidate in every slot, then a mix with
# (8, 7), the pair of phase 3c's tune that read two F in one batch, at
# five slots, two of them neighbours
BATCHES = {"same": [(8, 7)] * 8,
           "mixed": [(8, 7), (9, 3), (8, 7), (8, 7), (20, 6), (12, 2),
                     (8, 7), (8, 7)]}


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_vns_objective_of_repeated_candidates(batch):
    """A float32 Shell3x3 VNS objective batch through 'admm_fused' (40
    iterations, as chip_smoke.py phase 3c) on the CPU: every slot of one
    candidate reads the same closed-loop and open-loop bits and the same
    F."""
    problem, _ = build_problem(shell3x3.make_case(nit=40), dtype=F32,
                               qp_iters=15, device="cpu")
    problem.vns_qp_method = "admm_fused"
    problem.admm_iters = 40
    legs = {}
    for name in ("closed_batch", "open_batch"):
        fn = getattr(problem, name)

        def keep(*a, _fn=fn, _name=name, **kw):
            legs[_name] = _fn(*a, **kw)
            return legs[_name]
        setattr(problem, name, keep)
    pairs = BATCHES[batch]
    N_b, Nu_b = (np.array(x) for x in zip(*pairs))
    F = vns_objective_batch(problem, N_b, Nu_b, [2.36, 0.43, 0.81],
                            [0.066, 0.25, 0.086])
    assert np.isfinite(F).all()
    slots = [i for i, p in enumerate(pairs) if p == (8, 7)]
    my = problem.my
    for Y, U in legs.values():
        for x in (Y, U):
            x = np.asarray(x).reshape(len(pairs), my, *np.shape(x)[1:])
            for i in slots[1:]:
                assert np.array_equal(x[i].view(np.int32),
                                      x[slots[0]].view(np.int32)), i
    assert len(set(F[slots].tolist())) == 1, F[slots]
