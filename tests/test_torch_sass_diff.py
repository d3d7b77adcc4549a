"""``bench/sass_diff``'s reading and comparison of ``cuobjdump -sass``
output (the compile and disassembly need the CUDA toolkit)."""
from repro_torch.bench.sass_diff import compare, functions

SASS = """
	code for sm_90a
		Function : _ZN{n}_GLOBAL__N__8a1b2c3d_4_flash_cu_{h}6kernelEv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   {op} R2, R1, 0x1 ;                      /* 0x0000000101027810 */
        /*0020*/                   EXIT ;                                 /* 0x000000000000794d */
		..........
		Function : dsum_kernel
        /*0000*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def _sass(op="IADD3", h="0badf00d", extra=""):
    return SASS.format(n=45, h=h, op=op) + extra


def test_functions_drop_addresses_encodings_and_the_anonymous_name():
    f = functions(_sass())
    assert sorted(f) == ["_ZN45ANON6kernelEv", "dsum_kernel"]
    assert f["_ZN45ANON6kernelEv"][:3] == [
        ".headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS\"",
        "LDC R1, c[0x0][0x28] ;", "IADD3 R2, R1, 0x1 ;"]
    assert f["dsum_kernel"] == ["EXIT ;"]


def test_compare_names_identical_differing_and_one_sided_kernels():
    base = functions(_sass(h="0badf00d"))
    assert set(compare(base, functions(_sass(h="feedface"))).values()) \
        == {"identical (5 / 5 instructions)",
            "identical (1 / 1 instructions)"}
    extra = "\t\tFunction : split3_kernel\n        /*0000*/  EXIT ;\n"
    got = compare(base, functions(_sass(op="IMAD", extra=extra)))
    assert got == {"_ZN45ANON6kernelEv": "1 lines differ (5 / 5 instructions)",
                   "dsum_kernel": "identical (1 / 1 instructions)",
                   "split3_kernel": "only in this"}
