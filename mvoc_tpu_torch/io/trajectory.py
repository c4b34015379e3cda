"""Latent trajectory store: the state between inversion and composition
(the port's own copy of mvoc_tpu/io/trajectory.py; both packages read and
write the same files).

One container per video holds [steps, F, h, w, C] fp16 plus the timestep
vector, written once after inversion; the composite gathers the few
timesteps it needs.  Containers, in order of preference:
  1. the native mmap container (.mvoctraj, csrc/traj_codec.cpp via
     io/native.py): random-access step gathers, threaded fp16 <-> fp32;
  2. numpy .npz (when the codec cannot be built);
  3. the reference's per-step ``ddim_latents_{t}.pt`` files ([1, C, F, h, w]
     torch tensors), read only.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Sequence

import numpy as np

STACK_NAME = "ddim_trajectory.npz"
NATIVE_NAME = "ddim_trajectory.mvoctraj"
META_NAME = "inversion_meta.json"


class TrajectoryStore:
    """Read/write interface for one video's inversion trajectory
    (channels-last [F, h, w, C] latents per step)."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        self.prefer_native = prefer_native
        self._stack: np.ndarray | None = None
        self._timesteps: np.ndarray | None = None
        self._native = None  # io.native.NativeTrajReader

    # -- write ------------------------------------------------------------

    def save(self, timesteps: Sequence[int], latents: np.ndarray,
             meta: dict | None = None) -> str:
        """latents [steps, F, h, w, C]; timesteps[i] is the t of entry i.
        `meta`, a JSON-able dict of the producing config, goes beside the
        container so that consumers can detect a stale cache.  Returns the
        container's path."""
        os.makedirs(self.path, exist_ok=True)
        if meta is not None:
            with open(os.path.join(self.path, META_NAME), "w") as f:
                json.dump(meta, f, indent=1, default=str)
        ts = np.asarray(timesteps, dtype=np.int32)
        if self.prefer_native:
            from mvoc_tpu_torch.io import native

            out = os.path.join(self.path, NATIVE_NAME)
            if native.traj_write(out, ts, np.asarray(latents, dtype=np.float32)):
                return out
        out = os.path.join(self.path, STACK_NAME)
        np.savez(out, timesteps=ts, latents=np.asarray(latents).astype(np.float16))
        return out

    @property
    def meta(self) -> dict | None:
        p = os.path.join(self.path, META_NAME)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def matches_meta(self, expected: dict, missing_ok: bool = False) -> bool:
        """True when the stored trajectory was produced by `expected`
        (compared as strings on the keys both hold).  A store without a meta
        file does not match unless missing_ok: a cache of unknown provenance
        must not satisfy a skip-if-cached check."""
        got = self.meta
        if got is None:
            return missing_ok
        return all(str(got.get(k)) == str(v) for k, v in expected.items() if k in got)

    # -- read -------------------------------------------------------------

    def _open_native(self) -> bool:
        if self._native is not None:
            return True
        p = os.path.join(self.path, NATIVE_NAME)
        if not os.path.exists(p):
            return False
        try:
            from mvoc_tpu_torch.io import native

            self._native = native.NativeTrajReader(p)
            return True
        except (RuntimeError, FileNotFoundError):
            return False

    def _ensure_loaded(self) -> bool:
        if self._stack is not None:
            return True
        p = os.path.join(self.path, STACK_NAME)
        if os.path.exists(p):
            with np.load(p) as data:
                self._stack = data["latents"]
                self._timesteps = data["timesteps"]
            return True
        return False

    @property
    def timesteps(self) -> np.ndarray:
        if self._open_native():
            return self._native.timesteps
        if self._ensure_loaded():
            return self._timesteps
        ts = []
        for p in glob.glob(os.path.join(self.path, "ddim_latents_*.pt")):
            m = re.search(r"ddim_latents_(\d+)\.pt", os.path.basename(p))
            if m:
                ts.append(int(m.group(1)))
        if not ts:
            raise FileNotFoundError(f"no trajectory data in {self.path}")
        return np.asarray(sorted(ts), dtype=np.int32)

    def _indices_for(self, timesteps: Sequence[int]) -> np.ndarray:
        table = self.timesteps
        idx = []
        for t in timesteps:
            hits = np.nonzero(table == int(t))[0]
            if hits.size == 0:
                raise KeyError(f"timestep {t} not in trajectory {self.path} "
                               f"(have {len(table)} steps {table.min()}..{table.max()})")
            idx.append(int(hits[0]))
        return np.asarray(idx, dtype=np.uint32)

    def load_at_t(self, t: int) -> np.ndarray:
        """[F, h, w, C] float32 latents at exactly timestep t."""
        if self._open_native():
            return self._native.gather_indices(self._indices_for([t]))[0]
        if self._ensure_loaded():
            return self._stack[int(self._indices_for([t])[0])].astype(np.float32)
        return self._load_pt(int(t))

    def load_at_T(self) -> tuple[int, np.ndarray]:
        """(t, latents) at the noisiest stored step."""
        t = int(self.timesteps.max())
        return t, self.load_at_t(t)

    def gather(self, timesteps: Sequence[int]) -> np.ndarray:
        """[len(ts), F, h, w, C] float32."""
        if self._open_native():
            return self._native.gather_indices(self._indices_for(timesteps))
        return np.stack([self.load_at_t(int(t)) for t in timesteps])

    # -- the reference's per-step .pt files ---------------------------------

    def _load_pt(self, t: int) -> np.ndarray:
        p = os.path.join(self.path, f"ddim_latents_{t}.pt")
        if not os.path.exists(p):
            raise FileNotFoundError(f"missing latents at t={t}: {p}")
        import torch

        x = torch.load(p, map_location="cpu", weights_only=True).to(torch.float32).numpy()
        return np.transpose(x[0], (1, 2, 3, 0))  # [1, C, F, h, w] -> [F, h, w, C]
