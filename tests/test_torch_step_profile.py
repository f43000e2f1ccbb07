"""``analysis/step_profile.kernel_class`` on the kernel names a
``torch.profiler`` trace of the card gives (demangled, as the trace holds
them): every kernel of the port lands in its own class, the bf16
tensor-core kernels and the chunk-parallel SSD backward included; the two
bf16 SSD forwards share their chunk-parallel kernels and so one class."""
import pytest

from repro_torch.analysis.step_profile import kernel_class


@pytest.mark.parametrize("name,cls", [
    ("void flash::dq_wgmma_kernel<128>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, "
     "long long, long long, int, int, float)", "flash_dq"),
    ("void flash::dq_wgmma_kernel<256>(__nv_bfloat16 const*)", "flash_dq"),
    ("void flash::dq_kernel<float, 64>(float const*, float const*)",
     "flash_dq"),
    ("void flash::dkv_wgmma_kernel<128>(__nv_bfloat16 const*)", "flash_dkv"),
    ("flash::dkv_reduce_kernel(float const*, __nv_bfloat16*)", "flash_dkv"),
    ("void flash::fwd_wgmma_kernel<256>(__nv_bfloat16 const*)", "flash_fwd"),
    ("void flash::delta_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "flash_delta"),
    ("void ssd::bwd_u_kernel<64, 128>(ssd::BwdArgs, ssd::BwdScratch)",
     "ssd_bwd"),
    ("ssd::bwd_state_kernel(ssd::BwdArgs, ssd::BwdScratch, int)", "ssd_bwd"),
    ("void ssd::bwd_chunk_kernel<64, 128>(ssd::BwdArgs, ssd::BwdScratch)",
     "ssd_bwd"),
    ("ssd::bwd_ddA_kernel(ssd::BwdArgs, ssd::BwdScratch)", "ssd_bwd"),
    ("void ssd::bwd_kernel<float, 16, 16>(ssd::BwdArgs)", "ssd_bwd"),
    ("void ssd::fwd_kernel<__nv_bfloat16, 64, 128, true>(ssd::FwdArgs)",
     "ssd_fwd_res"),
    ("void ssd::fwd_kernel<__nv_bfloat16, 64, 128, false>(ssd::FwdArgs)",
     "ssd_fwd"),
    ("void ssd::fwd_kernel<float, 16, 16, true>(ssd::FwdArgs)",
     "ssd_fwd_res"),
    ("void ssd::fwd_u_kernel<64, 128>(ssd::FwdArgs, ssd::FwdScratch)",
     "ssd_fwd"),
    ("void ssd::fwd_state_kernel<64, 128>(ssd::FwdArgs, ssd::FwdScratch)",
     "ssd_fwd"),
    ("void ssd::fwd_chunk_kernel<16, 16>(ssd::FwdArgs, ssd::FwdScratch)",
     "ssd_fwd"),
    ("void rglru::bwd_kernel(float const*)", "rglru_bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int)", "other"),
])
def test_kernel_class_names_the_port_s_kernels(name, cls):
    assert kernel_class(name) == cls
