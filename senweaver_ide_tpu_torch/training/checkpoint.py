"""Train-state checkpointing with deterministic resume (PyTorch port).

Directory per step, ``<root>/step_N/{state.safetensors, meta.json}``: the
params, both AdamW moments, the optimizer's update count and the step go
through the port's safetensors codec into one file, and a JSON sidecar
carries the data-order cursor and any caller metadata, so a resumed run
continues from the exact batch it stopped at. ``meta.json`` is written
last (``.tmp`` then ``os.replace``): a step dir without it is torn and
never restored.

The JAX package saves through Orbax, or a ``.npz`` fallback; neither has
a counterpart here (an ``.npz`` cannot hold bf16 without ``ml_dtypes``),
and the ``use_orbax`` argument is gone. The optimizer itself is code, not
state: a restored state steps with the template's.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.safetensors_io import SafetensorsReader, save_file
from .trainer import AdamWState, TrainState, flatten_params, unflatten_params

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.safetensors"


def _meta_path(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step}", "meta.json")


def read_params_like(reader: SafetensorsReader, template: Mapping,
                     prefix: str = "", *, into: bool = False) -> Dict:
    """The tensors of ``template``'s structure from ``reader`` (names
    ``prefix + "layers/wq"`` …), each on its template tensor's device;
    shapes and dtypes must match. With ``into``, each is copied into its
    template tensor, one tensor at a time, and ``template`` is returned:
    no second tree is held."""
    pairs = []
    for name, t in flatten_params(template):
        key = prefix + name
        if key not in reader:
            raise KeyError(f"checkpoint lacks {key!r}")
        got = reader.get(key, t.device)
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(f"{key}: checkpoint {got.dtype}"
                             f"{tuple(got.shape)} != template {t.dtype}"
                             f"{tuple(t.shape)}")
        if into:
            t.copy_(got)
        else:
            pairs.append((name, got))
    return template if into else unflatten_params(pairs)


class CheckpointManager:
    """Directory-per-step checkpoints: ``<root>/step_N/{state, meta.json}``.

    ``keep_last`` bounds disk use (0 or None keeps every step)."""

    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)

    # -- public ------------------------------------------------------------
    def save(self, state: TrainState, *, data_cursor: int = 0,
             extra_meta: Optional[Dict[str, Any]] = None) -> str:
        step = int(state.step)
        step_dir = os.path.join(self.root, f"step_{step}")
        os.makedirs(step_dir, exist_ok=True)
        tensors = {}
        for group, tree in (("params/", state.params),
                            ("mu/", state.opt_state.mu),
                            ("nu/", state.opt_state.nu)):
            tensors.update((group + n, t) for n, t in flatten_params(tree))
        tensors["step"] = torch.tensor(step, dtype=torch.int64)
        tensors["count"] = torch.tensor(int(state.opt_state.count),
                                        dtype=torch.int64)
        save_file(tensors, os.path.join(step_dir, STATE_FILE))
        meta = {"step": step, "data_cursor": int(data_cursor),
                "format": "safetensors"}
        if extra_meta:
            meta.update(extra_meta)
        tmp = _meta_path(self.root, step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, _meta_path(self.root, step))
        self._gc()
        return step_dir

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_DIR_RE.match(name)
            # Only complete checkpoints (meta written last) count.
            if m and os.path.exists(_meta_path(self.root, int(m.group(1)))):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, template: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Restore into the structure of ``template`` (names, shapes and
        dtypes must match), each tensor on its template tensor's device.
        Returns (state, meta)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        meta_path = _meta_path(self.root, step)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no complete checkpoint for step "
                                    f"{step} under {self.root}")
        with open(meta_path) as f:
            meta = json.load(f)
        path = os.path.join(self.root, f"step_{step}", STATE_FILE)
        with SafetensorsReader([path]) as r:
            params = read_params_like(r, template.params, "params/")
            mu = read_params_like(r, template.opt_state.mu, "mu/")
            nu = read_params_like(r, template.opt_state.nu, "nu/")
            saved_step = int(r.get("step"))
            count = int(r.get("count"))
        return TrainState(params=params,
                          opt_state=AdamWState(count=count, mu=mu, nu=nu),
                          step=saved_step, opt=template.opt), meta

    # -- gc ----------------------------------------------------------------
    def _gc(self) -> None:
        if not self.keep_last:
            return
        complete: list = []
        torn: list = []
        for name in os.listdir(self.root):
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            s = int(m.group(1))
            (complete if os.path.exists(_meta_path(self.root, s))
             else torn).append(s)
        # Torn checkpoints (state written, meta.json never landed: a crash
        # mid-save) are garbage, not history: reclaim them first and never
        # count them toward keep_last, so a torn dir cannot evict a
        # complete checkpoint. A torn dir NEWER than every complete step
        # could be a save in progress, so it is spared.
        newest_complete = max(complete) if complete else None
        for s in torn:
            if newest_complete is not None and s <= newest_complete:
                shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                              ignore_errors=True)
        for s in sorted(complete)[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
