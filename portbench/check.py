"""The comparison that decides `correct`.

After the window has closed and the program's state is freed, the plain
float32 reference (portbench/reference/) steps the loop of the window's
first call at steps drawn from the seed, and each step's result is set
against what the program's step produced:

  * start_step: step 0 from the raw inputs alone: the reference's own
    conditioning (CLIP text and vision, the first frames' VAE encodes, with
    the call's random draws), its own start latents and noise fusion, its
    own mask pyramids, one UNet step with PnP injection, guidance and the
    DDIM update, and the next step's noise fusion; against the latents the
    program's step 1 takes (for an inversion, its trajectory's first entry);
  * later_step: the same for steps drawn from the seed after the first,
    each from the program's own input latents of that step (the loop can
    only be followed from the program's state: a float32 reference of every
    step would outlast the window), the largest of them.

The number is ||program - reference|| / ||reference - reference with zero
noise prediction||: the program's distance from the reference as a share
of what the UNet moved the latents in that step.  Where the workload names
a `floor` dtype (check.floor), each step is also run by the reference with
every dense and conv product rounded to that dtype, and the numbers
*_vs_floor give the program's distance in units of that run's: the network
that a seed's weights make amplifies every rounding alike, so the bf16
program reads about the same in these units on every seed, where its plain
distance moves 2.5x from seed to seed.  The reference reads the
program's latents only to judge them or, for later steps, as the state the
step starts from; it derives everything else from the raw inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench import inputs as I
from portbench.reference import model as M
from portbench.reference import pipeline as R


@dataclasses.dataclass
class CallRecord:
    """What the program produced in the checked call: `states` {step: the
    input latents [J, F, h, w, C] of the edit branches at that step} and
    `final` (composites: the returned latents; inversions: the trajectory
    [S, J, ...])."""

    states: dict
    final: Optional[torch.Tensor]


def draw_steps(seed: int, n_run: int, later: int) -> list:
    """Step 0 and `later` further steps drawn from the seed."""
    rng = np.random.default_rng(I.sub_seed(seed, "check"))
    pool = np.arange(1, n_run)
    picks = rng.choice(pool, size=min(later, len(pool)), replace=False) if len(pool) else []
    return [0] + sorted(int(s) for s in picks)


def tapped_steps(steps: list, n_run: int) -> set:
    """The steps whose input latents a check of `steps` reads."""
    return {s for s in steps if s > 0} | {s + 1 for s in steps if s + 1 < n_run}


def _rel(prog: torch.Tensor, ref: torch.Tensor, base: torch.Tensor) -> float:
    moved = float(torch.linalg.vector_norm((ref - base).double()))
    gap = float(torch.linalg.vector_norm((prog.to(ref.device).float() - ref).double()))
    return gap / moved if moved > 0 else float("inf")


def composite_plan(wl: dict, entries: list) -> R.CompositePlan:
    call = wl["call"]
    n = call["n_steps"]
    full = R.sampling_timesteps(n)
    run = full[call["ddim_init_latents_t_idx"]:]
    gates = R.injection_gates(full, run, n, {"conv": call["pnp_f_t"],
                                             "spatial": call["pnp_spatial_attn_t"],
                                             "temporal": call["pnp_temp_attn_t"]})
    lo, hi = call["fusion_steps"]
    for e in entries:
        idx = {int(t): i for i, t in enumerate(e.full_ts)}
        e.bg_run = e.bg_traj[[idx[int(t)] for t in run]]
        e.obj_run = np.stack([o[[idx[int(t)] for t in run]] for o in e.obj_traj], axis=1)
        e.obj_fusion = np.stack([o[idx[int(full[lo])]] for o in e.obj_traj])
    return R.CompositePlan(entries=entries, run_ts=run, gates=gates,
                           fusion=np.array([lo <= i < hi for i in range(len(run))]),
                           n_steps=n, n_obj=call["objects"], guidance=call["guidance"],
                           noise_ratio=call["random_noise_ratio"],
                           obj_noise=call["obj_random_noise_fusion"],
                           inject_background=call["inject_background"], fps=call["fps"])


def run_length(wl: dict) -> int:
    call = wl["call"]
    if wl["path"] == "inversion":
        return call["n_steps"]
    return call["n_steps"] - call["ddim_init_latents_t_idx"]


def call_batch_of(wl: dict) -> list:
    """For each sample of the fused branch batch, the batch of the program's
    UNet call that computes it (entry-major [bg, objects, uncond, cond])."""
    call, path = wl["call"], wl["path"]
    j, n = call["entries"], call.get("objects", 0)
    if path == "inversion":
        return [j] * j
    if path == "fused":
        return [j * (n + 3)] * (j * (n + 3))
    src = j if path == "stream" else j * (n + 1)
    return ([src] * (n + 1) + [2 * j] * 2) * j


def compare(cfg: dict, wl: dict, weights: dict, entries, record: CallRecord, steps: list,
            device, control_qmax: Optional[float] = None) -> dict:
    """{number: value} for the checked call.  control_qmax: the control of
    an int8 configuration, the reference at that many levels (7: w4a4) in
    the program's place, stepping from the same inputs."""
    precision = None
    if cfg.get("int8") is not None:
        precision = M.Precision(qmax=127.0, call_batch_of=call_batch_of(wl),
                                min_k=int(cfg["int8"].get("min_k", 1280)))
    if control_qmax is not None and precision is None:
        raise ValueError("a reference-in-place control needs an int8 configuration")
    towers = R.build_towers(cfg, weights, device, torch.float32, precision)
    ref = R.Reference(towers, device)

    def control(stepper):
        precision.qmax = control_qmax
        try:
            return stepper()[0]
        finally:
            precision.qmax = 127.0
    ctl = control if control_qmax is not None else None
    n_run = run_length(wl)
    with torch.no_grad():
        if wl["path"] == "inversion":
            out = _inversion(ref, wl, entries, record, steps, n_run, ctl)
        else:
            out = _composite(ref, wl, entries, record, steps, n_run, ctl)
    del towers, ref
    return out


def _program_next(record: CallRecord, s: int, n_run: int):
    if s + 1 < n_run:
        return record.states.get(s + 1)
    return record.final


def _composite(ref: R.Reference, wl, entries, record, steps, n_run, control) -> dict:
    call = dict(wl["call"])
    plan = composite_plan(wl, entries)
    conds = [ref.composite_cond(e, call) for e in entries]
    floor = _floor_dtype(wl)
    gaps, floors = {}, {}
    for s in steps:
        prog = _program_next(record, s, n_run)
        lat = ref.composite_start(conds, plan) if s == 0 else record.states.get(s)
        if prog is None or lat is None:
            continue
        lat = lat.to(ref.device).float()
        nxt, base = ref.composite_step(s, lat, conds, plan)
        if control is not None:
            prog = control(lambda: ref.composite_step(s, lat, conds, plan))
        gaps[s] = _rel(prog, nxt, base)
        if floor is not None:
            with M.rounded_products(ref.t.unet, floor):
                rounded, _ = ref.composite_step(s, lat, conds, plan)
            floors[s] = _rel(rounded, nxt, base)
    return _numbers(gaps, floors)


def _inversion(ref: R.Reference, wl, videos_and_seed, record, steps, n_run, control) -> dict:
    videos, ids, seed = videos_and_seed
    call = dict(wl["call"])
    cond = ref.inversion_cond(videos, ids, call, seed)
    ts = R.inversion_timesteps(call["n_steps"])
    traj = record.final  # [S, J, ...]
    gaps = {}
    for s in steps:
        if traj is None or s >= traj.shape[0]:
            continue
        lat = cond["x0"] if s == 0 else traj[s - 1].to(ref.device).float()
        nxt, base = ref.inversion_step(s, lat, cond, ts, call["n_steps"], call["fps"])
        prog = traj[s]
        if control is not None:
            prog = control(lambda: ref.inversion_step(s, lat, cond, ts, call["n_steps"],
                                                      call["fps"]))
        gaps[s] = _rel(prog, nxt, base)
    return _numbers(gaps)


def _floor_dtype(wl: dict):
    """The dtype whose rounding the workload's numbers are measured in
    (check.floor), or None for plain numbers."""
    name = wl["check"].get("floor")
    return None if name is None else getattr(torch, name)


def _numbers(gaps: dict, floors: dict | None = None) -> dict:
    """start_step / later_step (the largest later step); with floors also
    each step's gap in units of its floor (start_vs_floor, later_vs_floor)."""
    def split(d):
        later = [v for s, v in d.items() if s > 0]
        return d.get(0, float("nan")), max(later) if later else float("nan")
    out = dict(zip(("start_step", "later_step"), split(gaps)))
    if floors:
        ratios = {s: gaps[s] / floors[s] if floors[s] > 0 else float("inf") for s in floors}
        out.update(zip(("start_vs_floor", "later_vs_floor"), split(ratios)))
        out.update(zip(("start_floor", "later_floor"), split(floors)))
    out["steps_compared"] = float(len(gaps))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every limited number finite and within its limit."""
    return all(np.isfinite(numbers.get(k, np.nan)) and numbers[k] <= lim
               for k, lim in limits.items())
