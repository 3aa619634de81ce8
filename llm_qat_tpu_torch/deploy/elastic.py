"""Elastic training checkpoints: async saves + preemption restore.

Counterpart of `llm_qat_tpu/deploy/elastic.py`:
- `AsyncCheckpointManager.save(step, state)` copies the state to host
  memory synchronously (one device-to-host copy per tensor) and hands the
  disk write (npz + verify) to a background thread, so training resumes
  at once and the write overlaps the next steps;
- writes are atomic (tmp file + `os.replace`), so a preemption mid-write
  never corrupts the latest checkpoint; `keep` bounds disk usage;
- `restore_latest(template)` scans the directory for the newest complete
  step and falls back past a corrupt file: the relaunched job continues
  from wherever the last completed save was.

A state is any tree of dicts (walked by sorted keys, whatever their key
type: the optimizer's moments are keyed by path tuples), NamedTuples and
lists (by position), tensors and Python scalars. Leaves are stored by their
index in that order and restored into a live template of the same
structure: each tensor on the template leaf's device and dtype, each Python
scalar as the template's type (the train state's `int` step stays an
`int`). Optimizer state and step ride along with the params, so resume is
exact. The files are the port's own resume state; they are not meant to
load in the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import tree_leaves_with_keys

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")
_SCALARS = (bool, int, float)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves of `tree` in a deterministic order: dicts by sorted keys,
    NamedTuples, lists and tuples by position; None is no leaf."""
    return [leaf for _, leaf in tree_leaves_with_keys(tree)]


def tree_unflatten(template, leaves: List[Any]):
    """`template`'s structure with its leaves taken from `leaves` in
    `tree_leaves` order, each converted to the template leaf's kind."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the template's key order
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        v = next(it)
        if isinstance(t, torch.Tensor):
            out = torch.from_numpy(v)
            if t.dtype == torch.bfloat16 and out.dtype == torch.int16:
                out = out.view(torch.bfloat16)  # stored as its bits
            out = out.to(t.device)
            if out.dtype != t.dtype or out.shape != t.shape:
                raise ValueError(f"leaf {tuple(out.shape)} {out.dtype} does not "
                                 f"match the template's {tuple(t.shape)} {t.dtype}")
            return out
        if isinstance(t, _SCALARS):
            return type(t)(v.item())
        return v

    return build(template)


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)  # numpy has no bfloat16: keep the bits
        # a CPU tensor's numpy view would follow later in-place updates
        return t.cpu().numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.array(leaf)


def _atomic_savez(path: Path, flat: Dict[str, np.ndarray], meta: Dict,
                  max_retries: int = 3):
    tmp = path.with_suffix(".tmp.npz")
    for attempt in range(max_retries):
        try:
            np.savez(tmp, __meta__=json.dumps(meta), **flat)
            with np.load(tmp, allow_pickle=False) as loaded:
                for k, v in flat.items():
                    if not np.array_equal(loaded[k], v):
                        raise IOError(f"verify failed for {k}")
            os.replace(tmp, path)  # atomic: readers never see partial files
            return
        except (OSError, ValueError, zipfile.BadZipFile):
            if attempt == max_retries - 1:
                raise
            time.sleep(0.1)


class AsyncCheckpointManager:
    """Step-numbered async checkpoints with preemption restore.

    Usage:
        mgr = AsyncCheckpointManager(out_dir, keep=3)
        restored = mgr.restore_latest(init_state)   # None on a fresh start
        ...
        if step % save_every == 0:
            mgr.save(step, state)
        mgr.wait()                          # join pending writes at exit
    """

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- saving -----------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[Dict] = None):
        """Copy `state` to the host and save it asynchronously.

        Blocks only for the previous pending write (at most one in flight —
        bounds host memory at one snapshot) and the device-to-host copy.
        """
        self.wait()
        leaves = tree_leaves(state)
        flat = {f"leaf_{i:05d}": _host_copy(v) for i, v in enumerate(leaves)}
        m = {"step": int(step), "timestamp": time.time(),
             "n_leaves": len(leaves), "extra": meta or {}}
        path = self.dir / f"step_{int(step):010d}.npz"

        def work():
            try:
                _atomic_savez(path, flat, m)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight write; re-raise any background failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self._steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            try:
                (self.dir / f"step_{s:010d}.npz").unlink()
            except OSError:
                pass

    # -- restoring --------------------------------------------------------
    def _steps(self):
        out = []
        for p in self.dir.iterdir():
            match = _STEP_RE.match(p.name)
            if match:
                out.append(int(match.group(1)))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore_latest(self, template: Any
                       ) -> Optional[Tuple[int, Any, Dict]]:
        """(step, state, meta) of the newest complete checkpoint, or None.

        `template` is a live tree with the target structure (e.g. a
        freshly initialized train state); leaves are restored into it in
        `tree_leaves` order. Corrupt files (a crash can leave a torn tmp,
        never a torn step file — but disks lie) are skipped with a warning,
        falling back to the next-newest: the preemption-restart flow must
        come up with *some* valid state whenever one exists.
        """
        n_template = len(tree_leaves(template))
        for s in sorted(self._steps(), reverse=True):
            path = self.dir / f"step_{s:010d}.npz"
            try:
                with np.load(path, allow_pickle=False) as data:
                    meta = json.loads(str(data["__meta__"]))
                    n = meta["n_leaves"]
                    if n != n_template:
                        raise ValueError(
                            f"checkpoint has {n} leaves, template has "
                            f"{n_template}")
                    leaves = [data[f"leaf_{i:05d}"] for i in range(n)]
                return s, tree_unflatten(template, leaves), meta
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                print(f"WARNING: skipping corrupt checkpoint {path}: {e}")
                continue
        return None
