"""Latent trajectory store: the state between inversion and composition
(own copy of the npz container of mvoc_tpu/io/trajectory.py).

One container per video: [steps, F, h, w, C] fp16 plus the timestep
vector, written once after inversion; the composite gathers the timesteps
it needs.  The native `.mvoctraj` codec of the JAX package is not ported
yet; its stores are read only when they also hold the npz container."""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

STACK_NAME = "ddim_trajectory.npz"
META_NAME = "inversion_meta.json"


class TrajectoryStore:
    """Read/write interface for one video's inversion trajectory
    (channels-last [F, h, w, C] latents per step)."""

    def __init__(self, path: str):
        self.path = path
        self._stack: np.ndarray | None = None
        self._timesteps: np.ndarray | None = None

    def save(self, timesteps: Sequence[int], latents: np.ndarray, meta: dict | None = None) -> str:
        """latents [steps, F, h, w, C]; timesteps[i] is the t of entry i."""
        os.makedirs(self.path, exist_ok=True)
        if meta is not None:
            with open(os.path.join(self.path, META_NAME), "w") as f:
                json.dump(meta, f, indent=1, default=str)
        out = os.path.join(self.path, STACK_NAME)
        np.savez(out, timesteps=np.asarray(timesteps, dtype=np.int32),
                 latents=np.asarray(latents).astype(np.float16))
        return out

    def _load(self) -> None:
        if self._stack is None:
            p = os.path.join(self.path, STACK_NAME)
            if not os.path.exists(p):
                raise FileNotFoundError(f"no trajectory container {p}")
            with np.load(p) as data:
                self._stack = data["latents"]
                self._timesteps = data["timesteps"]

    @property
    def timesteps(self) -> np.ndarray:
        self._load()
        return self._timesteps

    def _index(self, t: int) -> int:
        hits = np.nonzero(self.timesteps == int(t))[0]
        if hits.size == 0:
            table = self.timesteps
            raise KeyError(f"timestep {t} not in trajectory {self.path} "
                           f"(have {len(table)} steps {table.min()}..{table.max()})")
        return int(hits[0])

    def load_at_t(self, t: int) -> np.ndarray:
        """[F, h, w, C] float32 latents at exactly timestep t."""
        self._load()
        return self._stack[self._index(t)].astype(np.float32)

    def gather(self, timesteps: Sequence[int]) -> np.ndarray:
        """[len(ts), F, h, w, C] float32."""
        return np.stack([self.load_at_t(int(t)) for t in timesteps])
