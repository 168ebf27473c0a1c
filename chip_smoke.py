#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit from nvidia-smi; TF32 off for the plain
   references;
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, at the reference test shapes and at the serving shape;
4. small reference: llama3-8b-smoke in fp32 on the card (through the
   kernels) against the same model on the CPU (plain versions);
5. serve: full-width llama3-8b (bf16, random weights from a seed), batch 4,
   a 1024-token prompt and 16 greedy tokens through ``serve()``, with the
   launch counts read around that one run, then the same model's warm
   prefill and decode steps under torch.profiler (device time by kernel,
   idle share);
6. kernel times at the serving shape beside their bound, the plain version
   and the PyTorch library call that computes the same function.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the per-kernel JSON record.  Without a CUDA device the
script exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import naive_attention, ops  # noqa: E402
from repro_torch.models import decode, lm  # noqa: E402
from repro_torch.runtime.serve_loop import ServeConfig, serve  # noqa: E402

ARCH = "llama3-8b"
BATCH, PROMPT, NEW_TOKENS = 4, 1024, 16
# the reference test shapes of flash attention (tests/test_kernels.py:26-30)
# and the serving shape of llama3-8b's prefill
TEST_SHAPES = [(2, 64, 4, 2, 16, 16, True), (1, 128, 8, 8, 32, 32, False),
               (2, 64, 4, 1, 16, 8, True), (1, 96, 6, 3, 8, 8, True)]
SERVE_SHAPE = (BATCH, PROMPT, 32, 8, 128, 128, True)
# fp32: summation order differs on the card; bf16: the reference's own bound
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# bf16 kernel against the plain version in fp32: about one bf16 output ulp
FP32_REF_TOL = 8e-3
MODEL_TOL = 2e-3             # the reference's prefill/decode bound
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s, FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def card() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(smi)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain references in full fp32: matmul.allow_tf32=False, "
          "cudnn.allow_tf32=False")
    return dev, smi


def build():
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def _qkv(shape, dtype, dev, seed):
    b, s, h, kv, dh, dv, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(sz, generator=gen, device=dev).to(dtype)
                 for sz in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dv)))


def vs_fp32_plain(out, q, k, v, causal):
    """The bf16 plain version rounds the scores and P to bf16, which the
    kernel does not: hold the kernel also against the plain version in fp32,
    the arithmetic it does, to about one bf16 ulp of each output."""
    ref = naive_attention(q.float(), k.float(), v.float(), causal=causal)
    err = (out.float() - ref).abs()
    worst = (err / (FP32_REF_TOL + FP32_REF_TOL * ref.abs())).max().item()
    print(f"flash_attention {tuple(q.shape)} bf16 against plain in fp32: "
          f"max|kernel - plain| = {err.max().item():.3e}, at {worst:.3f} of "
          f"atol=rtol={FP32_REF_TOL:g}")
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention disagrees with plain in fp32: "
                             f"{worst} of the bound")


def kernels_vs_plain(dev) -> float:
    """Returns the max |kernel - plain| at the serving shape."""
    cases = [(s, dt) for s in TEST_SHAPES for dt in (torch.float32, torch.bfloat16)]
    cases.append((SERVE_SHAPE, torch.bfloat16))
    before = ops.LAUNCHES
    serve_err = None
    for i, (shape, dtype) in enumerate(cases):
        q, k, v = _qkv(shape, dtype, dev, seed=i)
        out = ops.flash_attention(q, k, v, causal=shape[-1])
        torch.cuda.synchronize()
        ref = naive_attention(q, k, v, causal=shape[-1])
        err = (out.float() - ref.float()).abs().max().item()
        tol = KERNEL_TOL[dtype]
        print(f"flash_attention {shape[:-1]} causal={shape[-1]} {dtype}: "
              f"max|kernel - plain| = {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with plain: {err} > {tol}")
        if shape == SERVE_SHAPE:
            serve_err = err
            vs_fp32_plain(out, q, k, v, causal=shape[-1])
    if ops.LAUNCHES - before != len(cases):
        raise AssertionError(f"{len(cases)} calls, {ops.LAUNCHES - before} launches")
    return serve_err


def small_reference(dev):
    """llama3-8b-smoke in fp32: the card's path (kernels) against the CPU's
    (plain versions) on the same weights and prompt."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    cpu_params = lm.init(cfg, seed=1, device="cpu")
    gpu_params = _tree_map(lambda t: t.to(dev), cpu_params)
    tokens = make_batch(cfg, ShapeSpec("small", 64, 2, "prefill"), seed=1)["tokens"]
    before = ops.LAUNCHES
    worst = 0.0
    for params, device in ((cpu_params, "cpu"), (gpu_params, dev)):
        logits, cache = decode.prefill(params, {"tokens": tokens.to(device)}, cfg, 72)
        steps = [logits]
        for i in range(8):
            tok = tokens[:, i:i + 1].to(device)
            logits, cache = decode.decode_step(params, cache, tok, 64 + i, cfg)
            steps.append(logits)
        if device == "cpu":
            want = [s.float() for s in steps]
        else:
            for s, w in zip(steps, want):
                got = s.float().cpu()
                if not torch.isfinite(got).all():
                    raise AssertionError("non-finite logits on the card")
                torch.testing.assert_close(got, w, atol=MODEL_TOL, rtol=MODEL_TOL)
                worst = max(worst, (got - w).abs().max().item())
    if ops.LAUNCHES - before != cfg.n_layers:
        raise AssertionError("the small model's prefill did not launch the kernel "
                             "once per layer")
    print(f"small reference ({cfg.name}, fp32): card vs CPU logits over prefill "
          f"+ 8 decode steps, max|diff| = {worst:.3e} (tol {MODEL_TOL:g})")


def serve_full_width(dev) -> int:
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params in {cfg.param_dtype}, "
          f"{time.perf_counter() - t0:.1f} s")
    batch = make_batch(cfg, ShapeSpec("serve", PROMPT, BATCH, "prefill"), seed=0)
    torch.cuda.reset_peak_memory_stats(dev)

    ops.LAUNCHES = 0
    res = serve(cfg, params, batch, ServeConfig(max_new_tokens=NEW_TOKENS), device=dev)
    launches = ops.LAUNCHES

    toks = res["tokens"]
    print(f"serve: prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['tokens_per_s']:.1f} tokens/s ({res['decode_s'] * 1e3:.1f} ms for "
          f"{NEW_TOKENS - 1} steps), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
          f"flash_attention launches {launches}")
    print(f"first row: {toks[0].tolist()}")
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention {launches} times, "
                             f"not once per layer ({cfg.n_layers})")
    if toks.shape != (BATCH, NEW_TOKENS) or not bool((toks >= 0).all()) \
            or not bool((toks < cfg.vocab).all()):
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}")
    # the served path's logits: prefill again (outside the counted run) and
    # one decode step; the first served token is the prefill's argmax
    logits, cache = decode.prefill(params, {"tokens": batch["tokens"].to(dev)}, cfg,
                                   PROMPT + NEW_TOKENS)
    step, _ = decode.decode_step(params, cache, toks[:, :1], PROMPT, cfg)
    for name, lg in (("prefill", logits), ("decode", step)):
        if not bool(torch.isfinite(lg.float()[:, :cfg.vocab]).all()):
            raise AssertionError(f"non-finite {name} logits")
    if not torch.equal(logits.argmax(-1), toks[:, 0]):
        raise AssertionError("served first token is not the prefill's argmax")
    print("logits finite; first served token equals the prefill's argmax")
    del cache
    where_time_goes(params, cfg, batch["tokens"].to(dev))
    del params
    torch.cuda.empty_cache()
    return launches


def _profiled(name, fn):
    """fn() once on the host clock, then once more under torch.profiler:
    device time by kernel, and the device's idle share of the wall time
    taken with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in device}
    busy_ms = sum(by_kernel.values())
    if busy_ms == 0:
        print(f"profile {name}: wall {wall_ms:.1f} ms; the profiler saw no device "
              f"time, device busy share not measured")
        return
    print(f"profile {name}: wall {wall_ms:.1f} ms (host clock, profiler off), device "
          f"busy {busy_ms:.1f} ms in {sum(e.count for e in device)} device "
          f"activities (profiler), idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}")
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.2f} ms  {ms / busy_ms:6.1%}  {key[:100]}")


def where_time_goes(params, cfg, tokens, decode_steps=4):
    """Warm prefill and decode steps of the served model, profiled."""
    max_len = PROMPT + NEW_TOKENS
    _profiled("prefill", lambda: decode.prefill(params, {"tokens": tokens}, cfg, max_len))
    logits, cache = decode.prefill(params, {"tokens": tokens}, cfg, max_len)
    tok = logits.argmax(-1, keepdim=True)

    def steps():
        for i in range(decode_steps):
            decode.decode_step(params, cache, tok, PROMPT + i, cfg)

    _profiled(f"{decode_steps} decode steps", steps)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def time_ms(fn, warmup=3, reps=20) -> float:
    """Median of CUDA-event times of single calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def attention_bound(shape, dtype) -> tuple[float, str]:
    """Least time for the card: each input read once and the output written
    once at HBM rate, or the causal half of both products at the peak rate
    of the input type, whichever is larger."""
    b, s, h, kv, dh, dv, causal = shape
    elt = torch.empty((), dtype=dtype).element_size()
    moved = elt * b * s * (h * dh + kv * dh + kv * dv + h * dv)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * b * h * pairs * (dh + dv)
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_times(dev) -> dict:
    q, k, v = _qkv(SERVE_SHAPE, torch.bfloat16, dev, seed=100)
    causal = SERVE_SHAPE[-1]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
    plain_ms = time_ms(lambda: naive_attention(q, k, v, causal=causal))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True))
    bound_ms, bound_by = attention_bound(SERVE_SHAPE, torch.bfloat16)
    print(f"flash_attention at {SERVE_SHAPE[:-1]} bf16 causal: kernel {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms; "
          f"kernel at {bound_ms / ms:.1%} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main():
    dev, smi = card()
    build()
    err = kernels_vs_plain(dev)
    small_reference(dev)
    launches = serve_full_width(dev)
    times = kernel_times(dev)
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
        "launches": launches, "max_abs_err": err, **times}]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
