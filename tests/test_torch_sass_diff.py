"""scripts/port_sass_diff.py's reading of a cuobjdump listing, on small
hand-written listings (no CUDA toolkit needed): branch targets by label
or address, and the HMMA that may run with the warp diverged."""

import pytest

from scripts import port_sass_diff as sd

HEAD = """
	code for sm_90a
		Function : _Z6kernelPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
"""

# the product loop split on a lane-dependent predicate, each side with its
# own copy of the products (what nvcc made of lane-dependent operand
# selects before the fused steps' fetches became branch-free)
SPLIT = HEAD + """
        /*0000*/                   S2R R0, SR_LANEID ;            /* 0x0 */
        /*0010*/                   ISETP.GE.U32.AND P0, PT, R0, 0x18, PT ;
        /*0020*/              @!P0 BRA `(.L_x_1) ;
        /*0030*/                   HMMA.1688.F32.TF32 R4, R8, R12, RZ ;
        /*0040*/                   BRA `(.L_x_2) ;
.L_x_1:
        /*0050*/                   HMMA.1688.F32.TF32 R4, R8, R14, RZ ;
.L_x_2:
        /*0060*/                   EXIT ;
"""

# converged products; a loop's back edge, a branch on a uniform predicate
# and a BSSY region that holds no HMMA
CLEAN = HEAD + """
        /*0000*/                   BSSY B0, 0x40 ;
        /*0010*/               @P0 BRA 0x30 ;
        /*0020*/                   MOV R1, R2 ;
        /*0030*/                   BSYNC B0 ;
        /*0040*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0050*/              @!UP0 BRA 0x70 ;
        /*0060*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0070*/               @P1 BRA 0x40 ;
        /*0080*/                   EXIT ;
"""

# products inside a region where the warp may be diverged, and a
# predicated one
DIVERGED = HEAD + """
        /*0000*/                   BSSY B0, 0x30 ;
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0020*/                   BSYNC B0 ;
        /*0030*/               @P2 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0040*/                   EXIT ;
"""


def test_parse_resolves_labels():
    ins = sd.parse(SPLIT)["_Z6kernelPf"]
    assert [a for a, _ in ins] == [0x0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    assert ins[2][1] == "@!P0 BRA 0x50" and ins[4][1] == "BRA 0x60"
    assert ins[1][1] == "ISETP.GE.U32.AND P0, PT, R0, 0x18, PT"


@pytest.mark.parametrize("listing, n_hmma, unsafe",
                         [(SPLIT, 2, 1), (CLEAN, 2, 0), (DIVERGED, 2, 2)])
def test_hmma_unsafe(listing, n_hmma, unsafe):
    ins = sd.parse(listing)["_Z6kernelPf"]
    assert sd.count(ins, "HMMA") == n_hmma
    assert sd.hmma_unsafe(ins) == unsafe


@pytest.mark.parametrize("fn,base", [
    ("void bwd_kernel<1>(const float*, float*, int)", "bwd_kernel"),
    ("void fo_grad_kernel<false, 4>(const float*)", "fo_grad_kernel<false>"),
    ("void fo_grad_kernel<true>(const float*)", "fo_grad_kernel<true>"),
    ("void jvp8_kernel(const float*, float*)", "jvp8_kernel"),
])
def test_base_name_pairs_instantiations(fn, base):
    assert sd.base_name(fn) == base
