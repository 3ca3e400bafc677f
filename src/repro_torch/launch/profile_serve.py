"""Where the time of the LM serving path goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Serves h2o-danube-1.8b at full width as ``chip_smoke.py`` does (random bf16
weights from ``serve.SEED``, ``serve.BATCH`` prompts of ``serve.PROMPT_LEN``
tokens, ``serve.GEN`` new tokens each, through ``serve.random_model``). After one warm-up
generation it reports:

1. a warm generation: prefill time and the decode steps' time, each on the
   host clock after a synchronize (``serve.generate``), and the flash
   kernel's launches in the prefill;
2. a ``torch.profiler`` trace of one prefill and one of ``DECODE_STEPS``
   decode steps: wall time, device busy time, idle share, the largest items
   of device time, and the flash kernel's share of the prefill's device
   time. When the profiler records no device events, the device numbers are
   printed as "not measured";
3. mamba2-2.7b's scoring forward (``serve.SSM_ARCH``) on the same prompts'
   shape, through the SSD kernel: its warm time on the host clock after a
   synchronize, and a ``torch.profiler`` trace of one forward with its
   device time split into the SSD kernel (its C·Bᵀ pass included), the
   matrix products (cuBLAS) and the rest (elementwise passes and copies).

Needs a CUDA device; prints nothing it did not measure.
"""
from __future__ import annotations

import subprocess
import time

import torch

from repro_torch.configs import get_arch_config
from repro_torch.launch import serve
from repro_torch.launch.profile_round import profiled

B, P, G = serve.BATCH, serve.PROMPT_LEN, serve.GEN
DECODE_STEPS = 8
# device-kernel name fragments: the SSD kernel's two kernels, cuBLAS's
# matrix products
SSD_NAMES = ("ssd_kernel", "cb_kernel")
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def forward_split(by_name) -> dict:
    """Device ms of a forward by kind: ``ssd``, ``matmul``, ``other``."""
    split = {"ssd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        kind = ("ssd" if any(n in low for n in SSD_NAMES) else
                "matmul" if any(n in low for n in MATMUL_NAMES) else "other")
        split[kind] += ms
    return split


def profile_mamba() -> None:
    cfg = get_arch_config(serve.SSM_ARCH)
    print(f"[setup] {serve.SSM_ARCH} full width, forward B={B} S={P}")
    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        tokens = serve.random_prompts(cfg, B, P, serve.SEED, "cuda")

        def forward():
            model.forward(params, {"tokens": tokens}, last_only=True)

        forward()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        print(f"[warm] mamba forward {(time.perf_counter() - t0) * 1e3:.1f} "
              f"ms")
        by_name = profiled(forward, "mamba forward")
        if by_name:
            split = forward_split(by_name)
            total = sum(split.values())
            print("[mamba forward] device time by kind: " + ", ".join(
                f"{k} {ms:.1f} ms ({100 * ms / total:.1f}%)"
                for k, ms in split.items()) + f" of {total:.1f} ms")


def profile_danube() -> None:
    cfg = get_arch_config(serve.ARCH)
    print(f"[setup] {serve.ARCH} full width, B={B} prompt {P} gen {G}")
    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        prompts = serve.random_prompts(cfg, B, P, serve.SEED, "cuda")
        serve.generate(model, params, prompts, 2)  # warm-up
        res = serve.generate(model, params, prompts, G)
        steps = G - 1
        print(f"[warm] prefill {res['prefill_ms']:.1f} ms (flash launches "
              f"{res['flash_launches']}); decode {steps} steps in "
              f"{res['decode_s'] * 1e3:.1f} ms, "
              f"{res['decode_s'] * 1e3 / steps:.2f} ms a step, "
              f"{B * steps / res['decode_s']:.1f} tok/s")

        def prefill():
            model.forward(params, {"tokens": prompts}, return_cache=True,
                          last_only=True)

        by_name = profiled(prefill, "prefill")
        if by_name:
            total = sum(ms for ms, _ in by_name.values())
            flash = sum(ms for name, (ms, _) in by_name.items()
                        if "flash_kernel" in name)
            print(f"[prefill] flash kernel {flash:.1f} ms of {total:.1f} ms "
                  f"device time ({100 * flash / total:.1f}%)")
        cache = model.init_cache(B, P + G, device="cuda")
        token = res["tokens"][:, :1]

        def decode():
            for t in range(P, P + DECODE_STEPS):
                model.decode_step(params, cache, {"token": token}, t)

        profiled(decode, f"decode x{DECODE_STEPS}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"[setup] {smi}; tf32 off")
    profile_danube()
    torch.cuda.empty_cache()
    profile_mamba()


if __name__ == "__main__":
    main()
