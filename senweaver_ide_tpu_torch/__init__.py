"""senweaver_ide_tpu_torch: the PyTorch/CUDA port of ``senweaver_ide_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout module by module (``models/transformer.py`` ↔
``models/transformer.py``) and is held against it by the
``tests/test_torch_*.py`` suite. It imports torch and numpy and nothing
of JAX or of the JAX package.

Ported so far: the paged serving path, the GRPO trainer, the slot
layout, and the online GRPO round on them (agent sessions on one shared
engine, traces, the trace reward head, ``grpo_round``) with its
observability plane, the serving fleet around the engine, and the
control plane that runs training jobs on it.

- ``models``   — presets, the no-cache (training), contiguous-cache and
                 paged forwards, the numpy weight bridge.
- ``ops``      — RMSNorm, RoPE, GQA attention, sampling, and the Hopper
                 kernels (``csrc/``, built with ``nvcc`` at first use by
                 ``ops/_build.py``): paged flash-decode, flash attention
                 (forward and backward) and flash-decode over the
                 contiguous cache.
- ``rollout``  — the paged KV pool and allocator, the continuous-
                 batching ``RolloutEngine`` on the paged and slot
                 layouts, the ``generate`` loops, and the sessions
                 (``RolloutSession``, ``EnginePolicyClient``).
- ``training`` — GRPO, batching, LoRA, the trainer (with the guarded
                 step), the round-health diagnostics and ``rl_loop``
                 (``collect_group_trajectories``, ``grpo_round``).
- ``serve``    — the serving fleet: admission, routing, rolling and fenced
                 weight publication, the shared prefix store, migration,
                 remote replicas over HTTP, the disaggregated learner
                 (copies of the JAX package's, apart from the wire codec
                 for tensors and the device placement of what it decodes).
- ``runtime``  — the control plane: ``ControlServer`` on a unix socket,
                 the ``JobRunner`` that trains on it, and the native mmap
                 trace ring, byte tokenizer and ``senweaver-ctl`` CLI
                 (``native/``, built with g++ at first use into
                 ``_build/``).
- ``transport`` — clients for remote LLM providers.
- ``rewards``  — the 9-dimension trace reward head (torch, on the card).
- ``obs``      — tracing, metrics, telemetry, the fleet plane, and the
                 torch runtime profiler (``runtime_profile``).
- ``agents``, ``tools``, ``prompts``, ``traces``, ``resilience``,
  ``context``, ``editor``, ``services`` — the host-pure agent stack
                 around a session and the operator services (dashboard,
                 onboarding, SCM, ...), copied from the JAX package
                 (``tests/test_torch_copies.py`` holds each copy to its
                 original).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
