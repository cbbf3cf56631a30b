"""The parsers of `bitdistiller_tpu_torch.scripts.kernel_sass` on samples of
nvcc -Xptxas -v output and cuobjdump -sass listings, in the formats the CUDA
12 toolkit prints (the script itself needs the toolkit: card machine)."""

from bitdistiller_tpu_torch.scripts import kernel_sass as ks

PTXAS = """\
ptxas info    : 46 bytes gmem
ptxas info    : Compiling entry function '_Z3fooILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi64EEvPf
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 166 registers, used 2 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z3fooILi64EEvPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   WARPGROUP.ARRIVE ;                          /* 0x00000000000079cd */
                                                                               /* 0x000fe20000000000 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], R24, gsb0 ; /* 0x00e0 */
        /*0020*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;             /* 0x0000 */
        /*0030*/              @!P0 BRA 0x1af0 ;                                /* 0x0000 */
        /*0040*/                   HGMMA.64x64x16.F32.BF16 R88, R12, gdesc[UR12].tnspB, R88 ; /* 0x40 */
        /*0050*/                   STL.64 [R1+0x8], R26 ;                      /* 0x0000 */
        /*0060*/               @P1 LDL.LU.64 R26, [R1+0x8] ;                   /* 0x0000 */
        /*0070*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ; /* 0x0000 */
        /*0080*/                   HMMA.16816.F32.BF16 R40, R8, R12, R40 ;     /* 0x0000 */
\t\tFunction : _Z3barv
        /*0000*/                   EXIT ;                                      /* 0x000fea0003800000 */
"""


def test_parse_ptxas_reads_registers_and_spills_a_kernel():
    got = ks.parse_ptxas(PTXAS)
    assert got == {
        "_Z3fooILi64EEvPf": {"registers": 166, "spill_stores": 16, "spill_loads": 12},
        "_Z3barv": {"registers": 32, "spill_stores": 0, "spill_loads": 0},
    }


def test_parse_sass_counts_wgmmas_waits_and_local_memory_a_kernel():
    got = ks.parse_sass(SASS)
    assert got["_Z3fooILi64EEvPf"] == {"hgmma": 2, "wgmma_waits": 1, "hmma": 1, "stl": 1,
                                       "ldl": 1}
    assert got["_Z3barv"] == {"hgmma": 0, "wgmma_waits": 0, "hmma": 0, "stl": 0, "ldl": 0}
