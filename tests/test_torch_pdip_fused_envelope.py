"""The envelope of the single-solve PDIP kernel (``ops/kernels.
pdip_fused_envelope``, the arithmetic of ``ops/csrc/qp_fused.cu``'s
QpShape / PdipLayout): lanes and shared memory per block, the largest
admitted and the first refused shapes, that every capacity bucket the
Wood-Berry and Shell3x3 tunes build fits at both dtypes, and the list of
the normal matrix's terms that ``g_shared`` now builds for it.  Host
arithmetic only; the kernel itself is held against its plain version and
the one-thread design in ``tests/test_torch_gpu.py``."""

import pytest
import torch

from mpc_tuning_tpu_torch.cases import shell3x3, woodberry
from mpc_tuning_tpu_torch.ops.kernels import (FACTOR_SMEM_MAX, g_shared,
                                              pdip_fused_envelope)
from mpc_tuning_tpu_torch.sim.mpc_loop import horizon_caps
from mpc_tuning_tpu_torch.tuning.api import build_problem

torch.set_num_threads(1)  # small batches: threads only contend with workers

F32, F64 = torch.float32, torch.float64
# (n, mc) of Wood-Berry (64, 8) and Shell3x3 (127, 15), the widest bucket a
# tracking tune builds, and bytes a block: two n x (n | 1) tiles, six
# n-vectors and eleven mc-vectors a lane, 4 lanes of 4 bytes or 2 lanes of
# 8 bytes, so both dtypes need the same bytes
SMEM = {(17, 65): 22320, (46, 181): 105456}


@pytest.mark.parametrize("dtype,per_block", [(F32, 4), (F64, 2)])
@pytest.mark.parametrize("shape", sorted(SMEM))
def test_pdip_fused_envelope_arithmetic(shape, dtype, per_block):
    assert pdip_fused_envelope(dtype, *shape) == (per_block, SMEM[shape])


@pytest.mark.parametrize("dtype", [F32, F64])
def test_pdip_fused_envelope_first_refused(dtype):
    """At n = 46 the rows mc run up to 902 before a block's lanes need more
    than 227 KB; at mc = 181 the variables n run up to 64, the factor's two
    rows a lane, with room to spare; empty shapes and dtypes without a
    kernel are refused."""
    assert pdip_fused_envelope(dtype, 46, 902)[1] == 232352
    assert pdip_fused_envelope(dtype, 64, 181)[1] <= FACTOR_SMEM_MAX
    for n, mc in ((46, 903), (65, 181), (0, 181), (46, 0)):
        with pytest.raises(ValueError, match="pdip_fused kernel"):
            pdip_fused_envelope(dtype, n, mc)
    with pytest.raises(ValueError, match="float32 or float64"):
        pdip_fused_envelope(torch.float16, 46, 181)


def _buckets(mod):
    """Every capacity bucket a tune of case module ``mod`` can reach (each
    (N, Nu) up to the case's (127, 15)), with its G0 at float64."""
    problem, _ = build_problem(mod.make_case(nit=20), dtype=F64, device="cpu")
    d = problem.loop.dims
    p_max, m_max = d["p_max"], d["m_max"]
    caps = {horizon_caps(p_max, m_max, [N], [Nu])
            for N in range(2, p_max + 1) for Nu in range(1, min(N, m_max + 1))}
    assert (p_max, m_max) == (127, 15) and (127, 15) in caps
    return {c: problem.loop.capped(*c).arrays(F64, "cpu")["G0"]
            for c in sorted(caps)}


@pytest.mark.parametrize("mod", [woodberry, shell3x3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tracking_bucket_fits_pdip_fused(mod):
    """Every bucket is inside the envelope at both dtypes, so no tune
    meets a refusal; the widest is Shell3x3's n = 46, mc = 181."""
    widest = None
    for G0 in _buckets(mod).values():
        mc, n = G0.shape
        for dtype in (F32, F64):
            pdip_fused_envelope(dtype, n, mc)  # raises outside
        widest = max(widest or (0, 0), (n, mc))
    assert widest == ((31, 121) if mod is woodberry else (46, 181))


@pytest.mark.parametrize("caps", [(16, 4), (127, 15)])
def test_term_list_rebuilds_the_normal_matrix(caps):
    """``g_shared(G0, T2T)``'s term list (per lower entry (a, b) of G0' W
    G0 its rows r and G0[r, a] G0[r, b]), summed with unit weights in its
    order, rebuilds G0' G0's lower triangle exactly at float64; without
    T2T (no PDIP) it is not built."""
    G0 = _buckets(shell3x3)[caps]
    n = G0.shape[1]
    G = g_shared(G0, torch.zeros((n * n, G0.shape[0]), dtype=F64))
    ptr, row, coef = G["e_ptr"].long(), G["e_row"].long(), G["e_coef"]
    a_idx, b_idx = torch.tril_indices(n, n)
    assert ptr.shape == (a_idx.numel() + 1,) and int(ptr[-1]) == coef.numel()
    full = G0.T @ G0
    for e, (a, b) in enumerate(zip(a_idx.tolist(), b_idx.tolist())):
        terms = slice(int(ptr[e]), int(ptr[e + 1]))
        assert (row[terms].diff() > 0).all()  # ascending rows
        acc = torch.zeros((), dtype=F64)
        for q in range(terms.start, terms.stop):
            acc = acc + coef[q]
        assert torch.equal(acc, full[a, b]), (a, b)
        torch.testing.assert_close(coef[terms],
                                   G0[row[terms], a] * G0[row[terms], b],
                                   rtol=0, atol=0)
    assert "e_ptr" not in g_shared(G0)
