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
   printed as "not measured".

Needs a CUDA device; prints nothing it did not measure.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.configs import get_arch_config
from repro_torch.launch import serve
from repro_torch.launch.profile_round import profiled

B, P, G = serve.BATCH, serve.PROMPT_LEN, serve.GEN
DECODE_STEPS = 8


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_arch_config(serve.ARCH)
    print(f"[setup] {smi}; {serve.ARCH} full width, B={B} prompt {P} gen {G}")
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


if __name__ == "__main__":
    main()
