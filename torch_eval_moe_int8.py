"""int8 expert-bank quantization on a TRAINED MoE router (r3 weak #6).

r3 pinned int8-MoE behavior on a RANDOM tiny model (argmax agreement;
relative norm ~0.13 — honest but unrepresentative: a random router's
near-uniform logits flip on any perturbation). This eval trains the
tiny MoE policy first (GRPO on the ascii task through the real engine —
router + experts sharpen), THEN quantizes the expert banks
(models/quantize.py, router stays fp by design) and measures what
serving actually cares about:

- next-token argmax agreement over every position of a prompt batch,
- relative logit error (bf16 vs int8 forward),
- greedy-decode divergence (first index where the two decodes differ),

each reported for the TRAINED model and, as the baseline r3 used, the
random init — the delta quantifies how much of the flip risk was an
artifact of random routing.

    python torch_eval_moe_int8.py [--rounds 10] [--cpu]

Prints ONE JSON line (the MOE_INT8_r04 artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict


def train_tiny_moe(*, rounds: int, lr: float = 0.02, group_size: int = 16,
                   max_new_tokens: int = 8, seed: int = 0, device="cuda"):
    """GRPO ascii-task training of tiny-moe-test through the real stack
    (eval_learning's harness, with the trained params captured);
    returns (params, config, tok, curve)."""
    from torch_eval_learning import run_learning_eval
    from senweaver_ide_tpu_torch.models import get_config
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer

    cap: Dict = {}
    report = run_learning_eval(rounds=rounds, lr=lr, group_size=group_size,
                               max_new_tokens=max_new_tokens, seed=seed,
                               model="tiny-moe-test", short_prompt=True,
                               capture=cap, device=device)
    # Post-hoc curve dump (run_learning_eval has no per-round callback;
    # labeled so an operator tailing stderr does not mistake it for
    # live cadence on this hang-prone host).
    print(f"[moe-train] curve (post-hoc, {rounds} rounds): "
          f"{report['curve']}", file=sys.stderr, flush=True)
    return (cap["params"], get_config("tiny-moe-test"), ByteTokenizer(),
            report["curve"])


def compare_int8(params, config, tok, *, decode_tokens: int = 32) -> Dict:
    """bf16-vs-int8 forward + greedy-decode comparison on real prompts."""
    import torch
    import numpy as np

    from senweaver_ide_tpu_torch.models.quantize import quantize_weights_int8
    from senweaver_ide_tpu_torch.models.transformer import forward

    prompts = ["write plain ascii text", "emit the payload",
               "produce the message body", "def main():"]
    ids = [tok.encode(p, add_bos=True) for p in prompts]
    width = max(len(x) for x in ids)
    dev = params["embed"].device
    batch = torch.tensor([x + [tok.pad_id] * (width - len(x)) for x in ids],
                         dtype=torch.int32, device=dev)
    qparams = quantize_weights_int8(params)

    with torch.no_grad():
        ref = forward(params, config, batch)
        got = forward(qparams, config, batch)
    ref = ref.float().cpu().numpy()
    got = got.float().cpu().numpy()
    batch = batch.cpu()
    # Only REAL positions count: right-padding is ~a quarter of the
    # batch and its logits are semantically meaningless — averaging
    # over it would move the headline parity metrics with the prompt-
    # length spread instead of the model.
    valid = np.asarray(batch) != tok.pad_id
    agree = float(np.mean(ref.argmax(-1)[valid] == got.argmax(-1)[valid]))
    rel = float(np.linalg.norm(got[valid] - ref[valid])
                / np.linalg.norm(ref[valid]))

    # Greedy decode divergence: the strictest serving-level check.
    def greedy(p, n):
        toks = list(ids[0])
        for _ in range(n):
            with torch.no_grad():
                logits = forward(p, config, torch.tensor(
                    [toks], dtype=torch.int32, device=dev))
            toks.append(int(logits[0, len(toks) - 1].argmax()))
        return toks[len(ids[0]):]

    a = greedy(params, decode_tokens)
    b = greedy(qparams, decode_tokens)
    first_div = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
    return {
        "argmax_agreement": round(agree, 4),
        "relative_logit_error": round(rel, 4),
        "greedy_decode_tokens": decode_tokens,
        "greedy_first_divergence": first_div,
        "greedy_exact_match": bool(first_div is None),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    from senweaver_ide_tpu_torch.models import get_config, init_params
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer

    t0 = time.monotonic()
    config = get_config("tiny-moe-test")
    tok = ByteTokenizer()
    random_params = init_params(
        config, torch.Generator(device=device.type).manual_seed(args.seed),
        device=device)
    random_metrics = compare_int8(random_params, config, tok)

    trained_params, _cfg, _tok, curve = train_tiny_moe(
        rounds=args.rounds, seed=args.seed, device=device)
    trained_metrics = compare_int8(trained_params, config, tok)

    print(json.dumps({
        "metric": "moe_int8_trained_router",
        "trained": trained_metrics,
        "random_init_baseline": random_metrics,
        "train_curve": curve,
        "config": {"model": "tiny-moe-test", "rounds": args.rounds,
                   "seed": args.seed},
        "wall_s": round(time.monotonic() - t0, 1),
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
