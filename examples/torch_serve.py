"""Quickstart: serve a policy with continuous batching.

Runs the tiny test model by default so it works anywhere (CPU included);
point --model-dir at a local HF-layout checkpoint (e.g. a downloaded
Qwen/Qwen2.5-Coder-1.5B snapshot) to serve the real thing on the CUDA card.

    python examples/torch_serve.py [--model-dir DIR] [--prompt "def main():"]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--prompt", default="def fibonacci(n):")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch
    from senweaver_ide_tpu_torch.device import resolve_device

    from senweaver_ide_tpu_torch.models import get_config, init_params
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import RolloutEngine, SampleParams
    device = resolve_device("cpu" if args.cpu else "cuda")

    if args.model_dir:
        from senweaver_ide_tpu_torch.models import load_hf_params, load_tokenizer
        config = get_config("qwen2.5-coder-1.5b")
        params = load_hf_params(args.model_dir, config, device=device)
        tok = load_tokenizer(args.model_dir)
    else:
        config = get_config("tiny-test")
        params = init_params(config,
                             torch.Generator(device.type).manual_seed(0),
                             device=device)
        tok = ByteTokenizer()

    engine = RolloutEngine(params, config, num_slots=4, max_len=2048,
                           sample=SampleParams(temperature=0.8, top_p=0.95),
                           eos_id=tok.eos_id, device=device)
    rid = engine.submit(tok.encode(args.prompt, add_bos=True),
                        max_new_tokens=args.max_new_tokens)
    out = engine.run()[rid]
    print(f"[{config.name}] {len(out)} tokens:")
    print(tok.decode(out))


if __name__ == "__main__":
    main()
