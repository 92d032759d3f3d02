"""The card tools' host-side parts that need no card: how
``tools/host_cost.py`` assigns a profiled CUDA kernel's name to one of the
decode kernels B-F (D and F share their passes and differ only in the
load template argument), and the bounds ``tools/kernel_ab.py`` prints
beside the dense probe and the cache write."""
import pytest

from mm_s2ut_torch.tools import host_cost, kernel_ab


@pytest.mark.parametrize("name,kernel", [
    ("void mm::(anonymous namespace)::ancestry_q_score_kernel<__nv_bfloat16, 64, true, 0, 0>"
     "(mm::(anonymous namespace)::I8Args)", "D"),
    ("ancestry_q_out_kernel<float, 32, false, 0, 0>", "D"),
    ("ancestry_q_merge_kernel<__nv_bfloat16, 64, 0>", "D"),
    ("ancestry_q_score_kernel<__nv_bfloat16, 64, true, 1, 0>", "F"),
    ("ancestry_q_out_kernel<__nv_bfloat16, 64, true, 2, 0>", "F"),
    ("ancestry_q_merge_kernel<__nv_bfloat16, 64, 3>", "F"),
    ("ancestry_q_stats_kernel", "F"),
    ("ancestry_q_score_kernel<__nv_bfloat16, 64, true, 1, 7>", "F"),
    ("ancestry_q_out_kernel<__nv_bfloat16, 64, true, 0, 3>", "D"),
    ("ancestry_i8_out_kernel<__nv_bfloat16, 64, true>", "D"),
    ("ancestry_decode_q_kernel<__nv_bfloat16, 64, 8>", "F"),
    ("ancestry_split_kernel_mma<64>", "B"),
    ("cross_i8_split_kernel_mma<64, 0>", "E"),
    ("cross_decode_i8_kernel<__nv_bfloat16, 64>", "E"),
    ("cross_decode_merge_kernel<64>", "C"),
    ("flash_fwd_kernel_mma<64, false, false>", None),
])
def test_kernel_of(name, kernel):
    assert host_cost.kernel_of(name) == kernel


def test_probe_bounds():
    # Dense probe at int4_support_probe.py's shape: bytes-bound, the packed
    # slab half of the int8 one (q and out unchanged).
    B, H, K, Dh, S = 128, 8, 10, 64, 2010
    qo = 2 * B * H * K * Dh * 2
    assert kernel_ab.dense_bound_us(B, H, K, Dh, S, False) == pytest.approx(
        (B * H * S * 2 * Dh + qo) / 3.35e12 * 1e6)
    assert kernel_ab.dense_bound_us(B, H, K, Dh, S, True) == pytest.approx(
        (B * H * S * Dh + qo) / 3.35e12 * 1e6)
    # Cache write: rows read and written; int4 reads the packed rows too.
    rows = 128 * 6 * 8 * 10
    assert kernel_ab.write_bound_us("bfloat16", 128, 10, 6, 8, 64) == pytest.approx(
        rows * 512 / 3.35e12 * 1e6)
    assert kernel_ab.write_bound_us("int8", 128, 10, 6, 8, 64) == pytest.approx(
        rows * 272 / 3.35e12 * 1e6)
    assert kernel_ab.write_bound_us("int4", 128, 10, 6, 8, 64) == pytest.approx(
        rows * 400 / 3.35e12 * 1e6)
