"""``analysis/step_profile.kernel_class`` on the kernel names a
``torch.profiler`` trace of the card gives (demangled, as the trace holds
them): every kernel of the port lands in its own class, the bf16
tensor-core kernels and the chunk-parallel SSD backward included; the two
bf16 SSD forwards share their chunk-parallel kernels and so one class.
``range_device_ms`` on a small chrome trace of the same form, and the
ranges the RG-LRU block, the MoE layer and the encoder-decoder open."""
import pytest
import torch

from repro_torch.analysis.step_profile import kernel_class, range_device_ms
from repro_torch.configs import reduced_config
from repro_torch.models import layers, lm, moe, ssm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)


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
    ("rglru::fwd_kernel(float const*, float const*, float*, rglru::Tiles, "
     "rglru::Chain)", "rglru_fwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int)", "other"),
])
def test_kernel_class_names_the_port_s_kernels(name, cls):
    assert kernel_class(name) == cls


def _ev(cat, name, tid, ts, dur=1.0, **args):
    return {"cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_range_device_ms_takes_the_range_s_launches_and_its_backward():
    """A kernel counts for a range when the call that launched it (matched
    by correlation id) lies inside the range, or inside the backward node
    of an op the range ran (matched by sequence number, on another
    thread); other kernels do not count."""
    events = [
        _ev("user_annotation", "rglru_gates", 1, 0.0, 100.0),
        _ev("cpu_op", "aten::mm", 1, 10.0, 5.0, **{"Sequence number": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 12.0, correlation=1),
        _ev("kernel", "sm90_xmma_gemm_f32f32", 7, 20.0, 30.0, correlation=1),
        _ev("user_annotation", "rglru_scan", 1, 150.0, 20.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 155.0, correlation=4),
        _ev("kernel", "rglru::fwd_kernel", 7, 160.0, 8.0,
            correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 200.0, correlation=3),
        _ev("kernel", "elementwise", 7, 210.0, 40.0, correlation=3),
        _ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2,
            500.0, 20.0, **{"Sequence number": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 505.0, correlation=2),
        _ev("kernel", "sm90_xmma_gemm_f32f32", 7, 510.0, 50.0,
            correlation=2),
        _ev("cpu_op", "autograd::engine::evaluate_function: AddBackward0", 2,
            600.0, 20.0, **{"Sequence number": 9}),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 605.0, correlation=5),
        _ev("kernel", "elementwise", 7, 610.0, 60.0, correlation=5),
    ]
    got = range_device_ms(events)
    assert got == {
        "rglru_gates": {"fwd": 0.03, "bwd": 0.05, "fwd_matmul": 0.03,
                        "bwd_matmul": 0.05},
        "rglru_scan": {"fwd": 0.008, "bwd": 0.0, "fwd_matmul": 0.0,
                       "bwd_matmul": 0.0},
        **{n: dict.fromkeys(("fwd", "bwd", "fwd_matmul", "bwd_matmul"), 0.0)
           for n in (moe.ROUTE_RANGE, moe.EXPERTS_RANGE, moe.COMBINE_RANGE,
                     lm.ENCODER_RANGE, layers.CROSS_RANGE)}}


def test_rglru_block_opens_the_gates_and_scan_ranges():
    """One recurrentgemma-reduced forward opens each RG-LRU range once per
    RG-LRU layer."""
    cfg = reduced_config("recurrentgemma-2b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    p = params["groups"][0][0]["mixer"]
    layer = {k: v[0] for k, v in p.items()}
    x = torch.randn(1, 8, cfg.d_model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ssm.rglru_fwd(layer, x, cfg)
    names = [e.key for e in prof.key_averages()]
    for rng in (ssm.GATES_RANGE, ssm.SCAN_RANGE):
        assert rng in names
        assert next(e.count for e in prof.key_averages() if e.key == rng) == 1


def test_moe_layer_opens_the_route_experts_and_combine_ranges():
    """One qwen3-moe-reduced MoE layer opens each of its ranges once."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    layer = {k: v[0] for k, v in params["groups"][0][0]["ffn"].items()}
    x = torch.randn(1, 8, cfg.d_model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        moe.moe_fwd(layer, x, cfg)
    counts = {e.key: e.count for e in prof.key_averages()}
    for rng in (moe.ROUTE_RANGE, moe.EXPERTS_RANGE, moe.COMBINE_RANGE):
        assert counts.get(rng) == 1


def test_encoder_decoder_opens_the_encoder_and_cross_attention_ranges():
    """One seamless-reduced forward opens the encoder range once and the
    cross-attention range once per decoder layer."""
    cfg = reduced_config("seamless-m4t-medium")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "frames": torch.randn(1, 8, cfg.d_model)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lm.forward_train(params, batch, cfg)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get(lm.ENCODER_RANGE) == 1
    assert counts.get(layers.CROSS_RANGE) == cfg.num_layers
