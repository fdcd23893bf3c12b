"""senweaver_ide_tpu_torch: the PyTorch/CUDA port of ``senweaver_ide_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout module by module (``models/transformer.py`` ↔
``models/transformer.py``) and is held against it by the
``tests/test_torch_*.py`` suite. It imports torch and numpy and nothing
of JAX or of the JAX package.

Ported so far: the paged serving path, the GRPO trainer and the slot
layout.

- ``models``   — presets, the no-cache (training), contiguous-cache and
                 paged forwards, the numpy weight bridge.
- ``ops``      — RMSNorm, RoPE, GQA attention, sampling, and the Hopper
                 kernels (``csrc/``, built with ``nvcc`` at first use by
                 ``ops/_build.py``): paged flash-decode, flash attention
                 (forward and backward) and flash-decode over the
                 contiguous cache.
- ``rollout``  — the paged KV pool and allocator, the continuous-
                 batching ``RolloutEngine`` on the paged and slot
                 layouts, and the ``generate`` loops.
- ``training`` — GRPO, batching, LoRA and the trainer.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
