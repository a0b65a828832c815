#!/usr/bin/env python3
"""Why ``chip_smoke.py`` holds whisper-tiny and internvl2-76b as it does.

    python3 agreement_check.py [--out FILE]       # needs one CUDA device and nvcc

Both at ``chip_smoke.py``'s serving shapes, bf16 weights from seed 0 on the
card, the int8 engine beside its bf16 twin (``chip_smoke.twin_engines``).

* **whisper-tiny, the cross-attention's draw.**  ``attention_fan_in``
  rescales all three of its attentions.  Its ``cross`` variant puts the
  cross-attention back at the reference's draw (``shape[-2]``, the head
  count, as the fan-in).  For each variant: the greedy-chain agreement with
  the twin and the distinct tokens of the chains (``chip_smoke.py``'s
  generate workload), and one prompt over seeded random frames through
  ``prefill`` against its chunked composition (``frontend_prefill``'s
  inputs): the largest |difference| of the last logits and of the
  self-attention K/V over the largest |value|.
* **internvl2-76b (8 layers), six prompt draws** of the generate workload:
  the greedy-chain agreement with the twin, the per-step agreement and the
  int8 - bf16 logit difference (``chip_smoke.step_agreement``), the median
  top-2 gap of the twin's logits over its largest |logit|, and verify's
  per-position agreement with plain decode (``chip_smoke.verify_steps``,
  any failure recorded, not raised) with the chain margins of its flips.
  The first draw's verify is also run with cuBLAS's reduced-precision bf16
  reductions off, then on.

Prints one JSON line per case, then the card's name and power limit; exits
1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.kv_cache import cache_defs  # noqa: E402

VLM_DRAWS = (100, 101, 102, 103, 104, 105)


@contextlib.contextmanager
def failures_recorded():
    """Within, ``chip_smoke.fail`` appends its message to the list this
    yields instead of raising."""
    seen, real = [], cs.fail
    cs.fail = seen.append
    try:
        yield seen
    finally:
        cs.fail = real


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return cs.r6(float((got - want).abs().max() / want.abs().max()))


def whisper_case(dev, cross: str) -> dict:
    """whisper-tiny with its cross-attention rescaled (``cross`` =
    "standard") or at the reference's draw ("reference")."""
    cfg = get_config(cs.WHISPER)
    real = rescale = cs.attention_fan_in
    if cross == "reference":  # the rescale of every attention but the cross one
        def rescale(params, cfg):
            saved = {k: v.clone() for k, v in params["blocks"]["cross_attn"].items()}
            real(params, cfg)
            params["blocks"]["cross_attn"].update(saved)
    cs.attention_fan_in = rescale
    try:
        eng, full, _ = cs.twin_engines(dev, cfg)
    finally:
        cs.attention_fan_in = real
    rng = np.random.default_rng(80)
    prompts = rng.integers(0, cfg.vocab_size, (cs.GEN_PROMPTS, cs.GEN_LEN)).astype(np.int32)
    tokens_q = eng.generate(prompts, cs.GEN_NEW)
    chain = float((tokens_q == full.generate(prompts, cs.GEN_NEW)).mean())
    rng = np.random.default_rng(82)
    n = cs.FRONTEND_PROMPT
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
    fe = torch.as_tensor(rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)),
                         dtype=cfg.dtype, device=dev)
    with torch.inference_mode():
        logits, cache = engine_mod.prefill(eng.params, toks, eng.cfg, frontend_embeds=fe)
        chunked = init_params(cache_defs(eng.cfg, batch=1, max_len=n), torch.Generator(), dev)
        ck, cv = engine_mod.encoder_cross_cache(eng.params, eng.cfg, fe)
        chunked["cross_k"].copy_(ck)
        chunked["cross_v"].copy_(cv)
        for pos in range(0, n, cs.CHUNK_TOKENS):
            clog, chunked = engine_mod.prefill_chunk(eng.params, chunked,
                                                     toks[:, pos:pos + cs.CHUNK_TOKENS], pos,
                                                     eng.cfg)
    v = cfg.vocab_size
    out = {"arch": cs.WHISPER, "cross_attention": cross, "chain_agreement": cs.r6(chain),
           "distinct_tokens": len(set(tokens_q.ravel().tolist())), "of": int(tokens_q.size),
           "random_frames_prefill": {"logits": rel_err(clog[:, :v], logits[:, :v]),
                                     "k": rel_err(chunked["k"], cache["k"]),
                                     "v": rel_err(chunked["v"], cache["v"])}}
    del eng, full
    torch.cuda.empty_cache()
    return out


def vlm_cases(dev) -> list[dict]:
    cfg = dataclasses.replace(get_config(cs.VLM), num_layers=cs.VLM_LAYERS)
    eng, full, _ = cs.twin_engines(dev, cfg, cs.VLM_SC)
    v, out = cfg.vocab_size, []
    for seed in VLM_DRAWS:
        prompts = np.random.default_rng(seed).integers(
            0, v, (cs.GEN_PROMPTS, cs.image_rows(eng) + cs.GEN_LEN)).astype(np.int32)
        tokens_q, tokens_f = eng.generate(prompts, cs.GEN_NEW), full.generate(prompts, cs.GEN_NEW)
        per_step = cs.step_agreement(eng, full, prompts, tokens_f, dev)
        ctx = torch.as_tensor(prompts.astype(np.int64), device=dev)
        with torch.inference_mode():
            lf, _ = engine_mod.prefill(full.params, ctx, full.cfg,
                                       frontend_embeds=full._frontend_stub(len(prompts)))
        top2 = torch.topk(lf[:, :v], 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / lf[:, :v].abs().amax(-1)
        settings = (False, True) if seed == VLM_DRAWS[0] else (None,)
        for reduced in settings:
            if reduced is not None:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            report = {}
            with failures_recorded() as failed:
                cs.verify_steps(eng, np.random.default_rng(seed), "agreement_check", report)
            s = report["speculative"]
            out.append({
                "arch": cs.VLM, "layers": cfg.num_layers, "seed": seed,
                "bf16_reduced_precision_reduction":
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                "chain_agreement": cs.r6(float((tokens_q == tokens_f).mean())),
                "step_agreement": per_step["agreement"],
                "int8_vs_bf16_logits_max_rel": per_step["logits_max_abs_diff_rel"],
                "bf16_top2_gap_rel_median": cs.r6(float(gap.median())),
                "verify_agreement": s["per_position_agreement"],
                "verify_logits_max_rel": s["logits_max_abs_diff_rel"],
                "verify_flip_margins": [f["chain_margin_rel"] for f in s["flips"]],
                "failures": failed})
            print(json.dumps(out[-1]), flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the lines to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("agreement_check: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runtime.load_kernels()
    lines = []
    for cross in ("standard", "reference"):
        lines.append(whisper_case(dev, cross))
        print(json.dumps(lines[-1]), flush=True)
    lines += vlm_cases(dev)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"gpu": smi, "lines": lines}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
