#!/usr/bin/env python3
"""Why ``chip_smoke.py`` rescales the random weights of the ssm and hybrid
families before it serves them (``chip_smoke.standard_fan_in``).

    python3 ssm_rescale_check.py [--out FILE]     # needs one CUDA device and nvcc

mamba2-780m and zamba2-7b at full width and full depth, bf16 weights drawn
from seed 0 on the card.  The steps of ``standard_fan_in`` are applied one
after another (``attention_fan_in``, ``depth_scaled_mamba``,
``embedding_at_residual_scale``); after each, the int8 engine
(``quant="int8"``) and the bf16 engine over the same weights are compared
on ``chip_smoke.py``'s generate workload (4 prompts of 64 tokens, 8 new
tokens) under four prompt draws:

* ``hidden_rel``: |h_int8 - h_bf16| / |h_bf16| of the final hidden states
  over the prompts (``forward``);
* ``argmax_kept``: the share of prompt positions whose next-token argmax is
  the same in both;
* ``chain_agreement``: the share of generated tokens that are the same
  (what ``chip_smoke.py`` holds to its floor, 0.3).

It also reads, once a config, the largest entry over the RMS of each row
that the int8 path quantizes in front of each Mamba2 projection (mean over
rows and layers).  Prints one JSON line per (arch, steps applied), then the
card's name and power limit; exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import unembed_apply  # noqa: E402
from repro_torch.models.quant import quantize_params  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

DRAWS = (60, 61, 62, 63)
STEPS = (("attention_fan_in", lambda p, cfg: cs.attention_fan_in(p, cfg)),
         ("depth_scaled_mamba", lambda p, cfg: cs.depth_scaled_mamba(p)),
         ("embedding_at_residual_scale", lambda p, cfg: cs.embedding_at_residual_scale(p)))


def row_peaks(params, cfg, toks) -> dict:
    """Largest |entry| over RMS of the rows quantized in front of each
    Mamba2 projection, mean over rows and layers, in one int8 forward."""
    seen, real = {}, ssm_mod.qeinsum
    names = {"bsd,di->bsi": "wz_wx_input", "bsi,id->bsd": "wo_input"}

    def spy(spec, x, w):
        rows = x.float().reshape(-1, x.shape[-1])
        peak = rows.abs().amax(-1) / rows.pow(2).mean(-1).sqrt()
        seen.setdefault(names[spec], []).append(float(peak.mean()))
        return real(spec, x, w)

    ssm_mod.qeinsum = spy
    try:
        with torch.inference_mode():
            model_mod.forward(params, toks, cfg)
    finally:
        ssm_mod.qeinsum = real
    return {k: round(sum(v) / len(v), 3) for k, v in seen.items()}


def compare(arch: str, steps: int, dev) -> dict:
    cfg = get_config(arch)
    cfg_q = dataclasses.replace(cfg, quant="int8")
    params = model_mod.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for _, step in STEPS[:steps]:
        step(params, cfg)
    quant = quantize_params(params, cfg_q)
    sc = engine_mod.ServeConfig(max_batch=4, max_len=128)
    eng_q = engine_mod.InferenceEngine(cfg_q, params=quant, sc=sc)
    eng_f = engine_mod.InferenceEngine(cfg, params=params, sc=sc)
    out = {"arch": arch, "steps": [name for name, _ in STEPS[:steps]], "draws": list(DRAWS),
           "hidden_rel": [], "argmax_kept": [], "chain_agreement": []}
    vocab = cfg.vocab_size
    for seed in DRAWS:
        prompts = np.random.default_rng(seed).integers(0, vocab, (cs.GEN_PROMPTS, cs.GEN_LEN))
        toks = torch.as_tensor(prompts, device=dev)
        with torch.inference_mode():
            h_f, _ = model_mod.forward(params, toks, cfg)
            h_q, _ = model_mod.forward(quant, toks, cfg_q)
            arg_f = unembed_apply(params["embed"], h_f, cfg)[..., :vocab].argmax(-1)
            arg_q = unembed_apply(quant["embed"], h_q, cfg_q)[..., :vocab].argmax(-1)
        out["hidden_rel"].append(cs.r6(float((h_q.float() - h_f.float()).norm()
                                             / h_f.float().norm())))
        out["argmax_kept"].append(cs.r6(float((arg_q == arg_f).float().mean())))
        p32 = prompts.astype(np.int32)
        out["chain_agreement"].append(cs.r6(float(
            (eng_q.generate(p32, cs.GEN_NEW) == eng_f.generate(p32, cs.GEN_NEW)).mean())))
        if seed == DRAWS[0]:
            out["row_peak_over_rms"] = row_peaks(quant, cfg_q, toks)
    out["chain_agreement_mean"] = cs.r6(float(np.mean(out["chain_agreement"])))
    del params, quant, eng_q, eng_f
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the lines to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_rescale_check: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runtime.load_kernels()
    lines = []
    for arch, steps in (("mamba2-780m", (1, 2)), ("zamba2-7b", (1, 2, 3))):
        for n in steps:
            lines.append(compare(arch, n, dev))
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"gpu": smi, "lines": lines}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
