#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It
imports nothing of JAX. Phases, each fatal on failure:

1. Device: the card's name and power limit (nvidia-smi), and the list
   of hand-written kernels on the path (none in this slice).
2. Fleet replay at full width: ``ppo-cnn-philly512`` (64 nodes x 8
   GPUs, 128-job windows, queue 16, horizon 1024, the CNN actor-critic
   in bf16 with seeded weights) against 512 simulated clusters through
   ``fleet_replay``; then a ``torch.profiler`` account of the decision
   step (launches per step, top device ops, device idle share).
3. Card against CPU: the first 8 clusters replayed at f32 with TF32
   off on ``cuda`` and on ``cpu`` with the same weights. Greedy actions
   must agree step by step, except at a step where the CPU's top-two
   logit margin is below 1e-4; that cluster is no longer compared from
   there on. Clusters compared to the end must agree on ``steps`` and
   ``n_done`` exactly and on ``avg_jct`` within rtol 1e-6 (an f32 sum
   over the window, whose order differs between the devices).
4. Requests: a pool of (obs, mask) rows the greedy policy reaches on
   the config-2 env goes through ``InferenceEngine`` after a warmup up
   to bucket 256; three request sizes in each of two buckets. Served
   actions must equal ``policy_decision`` on the same rows (padded to
   the bucket: exactly; unpadded: up to the phase-3 margin rule). Prints
   p50/p99 ``decide`` latency per bucket.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit. Without a CUDA device, or
without the ``rlgpuschedule_tpu_torch`` package beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

CONFIG = "ppo-cnn-philly512"
N_CLUSTERS = 512          # the serve CLI's documented --fleet 512
N_COMPARE = 8
MARGIN = 1e-4
BUCKETS = {16: (9, 12, 16), 256: (129, 200, 256)}
LATENCY_REPS = 30


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _line(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def _finite(*xs) -> bool:
    return all(math.isfinite(float(x)) for x in xs)


def fleet_phase(torch, cfg, env_params, traces, dev):
    from rlgpuschedule_tpu_torch.models import make_policy
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_replay

    policy = make_policy(cfg.obs_kind, env_params.n_actions,
                         env_params.obs_shape(), seed=cfg.seed,
                         device=dev)
    # first-call costs (allocator, cuDNN/cuBLAS handles) outside the
    # timed run
    fleet_replay(policy, env_params, traces, max_steps=4, device=dev)
    fl = fleet_replay(policy, env_params, traces, device=dev)
    pc = fl["per_cluster"]
    _line("fleet", config=cfg.name, n_clusters=fl["n_clusters"],
          horizon=env_params.horizon, dtype="bfloat16",
          decisions=fl["decisions"], wall_s=fl["wall_s"],
          decisions_per_s=fl["decisions_per_s"],
          mean_jct=fl["mean_jct"], completion=fl["completion"],
          max_steps_taken=max(pc["steps"]), min_steps_taken=min(pc["steps"]))
    if not fl["completion"] > 0:
        raise SystemExit("fleet replay completed no job")
    if not _finite(fl["mean_jct"], fl["completion"], fl["wall_s"],
                   fl["decisions_per_s"], *pc["avg_jct"], *pc["makespan"]):
        raise SystemExit("fleet replay reported a non-finite value")
    return policy


def profile_phase(torch, env_params, traces, policy):
    """Kernel launches per decision step, from the difference of two
    replay lengths (which cancels reset and final statistics); device
    time by op and the device idle share over the longer one, with and
    without the profiler's own overhead on the host; and the policy's
    share of a step."""
    from torch.profiler import ProfilerActivity, profile

    from rlgpuschedule_tpu_torch.env import env as env_lib
    from rlgpuschedule_tpu_torch.eval import replay

    def timed(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(policy, env_params, traces, max_steps=steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run(steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(steps)
        device_ops = [e for e in prof.events()
                      if e.device_type.name == "CUDA"]
        return prof, device_ops, wall

    s1, s2 = 8, 40
    _, k1, _ = run(s1)
    prof, k2, wall = run(s2)
    wall_plain = timed(s2)
    busy_s = sum(e.time_range.elapsed_us() for e in k2) / 1e6
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in k2)
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda r: -r[1])[:10]
    # the policy alone on the replay's first observation, CUDA events
    with torch.inference_mode():
        _, ts = env_lib.reset(env_params, traces)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        policy(ts.obs, ts.action_mask)
        start.record()
        for _ in range(20):
            policy(ts.obs, ts.action_mask)
        end.record()
        torch.cuda.synchronize()
    _line("profile", steps=s2, device_ops=len(k2), copies_and_sets=copies,
          launches_per_step=(len(k2) - len(k1)) / (s2 - s1),
          device_busy_s=busy_s, window_s=wall,
          device_idle_share=1.0 - busy_s / wall,
          window_s_unprofiled=wall_plain,
          device_idle_share_unprofiled=1.0 - busy_s / wall_plain,
          step_ms_unprofiled=wall_plain / s2 * 1e3,
          policy_forward_ms=start.elapsed_time(end) / 20,
          top_device_ops=[{"op": k, "device_ms": t / 1e3, "calls": c}
                          for k, t, c in ops])
    if not k2:
        raise SystemExit("the profiler saw no kernel on the card")


def compare_phase(torch, cfg, env_params, windows, dev):
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import replay
    from rlgpuschedule_tpu_torch.models import make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sub = windows[:N_COMPARE]
    out = {}
    for side in (dev, "cpu"):
        policy = make_policy(cfg.obs_kind, env_params.n_actions,
                             env_params.obs_shape(), dtype=torch.float32,
                             seed=cfg.seed, device=side)
        traces = stack_traces(sub, env_params, side)
        res, rec = replay(policy, env_params, traces, record=True)
        out[side] = ({k: v.cpu() for k, v in res._asdict().items()},
                     rec.actions.cpu(), rec.margin.cpu())
    (rg, ag, _), (rc, ac, mc) = out[dev], out["cpu"]
    cut, compared = {}, []
    for e in range(N_COMPARE):
        n = min(int(rg["steps"][e]), int(rc["steps"][e]), ac.shape[0],
                ag.shape[0])
        diff = (ag[:n, e] != ac[:n, e]).nonzero().flatten()
        if diff.numel():
            s = int(diff[0])
            if float(mc[s, e]) >= MARGIN:
                raise SystemExit(
                    f"cluster {e}: card and CPU actions differ at step {s} "
                    f"where the CPU's top-two margin is {float(mc[s, e])}")
            cut[e] = (s, float(mc[s, e]))
            continue
        compared.append(e)
        for k in ("steps", "n_done"):
            if int(rg[k][e]) != int(rc[k][e]):
                raise SystemExit(f"cluster {e}: {k} {int(rg[k][e])} on the "
                                 f"card vs {int(rc[k][e])} on the CPU")
    rel = max((abs(float(rg["avg_jct"][e]) - float(rc["avg_jct"][e]))
               / max(abs(float(rc["avg_jct"][e])), 1e-30)
               for e in compared), default=0.0)
    _line("card_vs_cpu", clusters=N_COMPARE, dtype="float32", tf32=False,
          compared_to_end=len(compared),
          cut_short={str(e): {"step": s, "cpu_margin": m}
                     for e, (s, m) in cut.items()},
          steps=[int(x) for x in rc["steps"]],
          n_done=[int(x) for x in rc["n_done"]],
          avg_jct_max_rel_diff=rel)
    if rel > 1e-6:
        raise SystemExit(f"avg_jct differs by {rel} (relative) between the "
                         f"card and the CPU")
    if not compared:
        raise SystemExit("no cluster was compared to the end")


def request_phase(torch, env_params, traces, policy, dev):
    import numpy as np

    from rlgpuschedule_tpu_torch.decision import policy_decision
    from rlgpuschedule_tpu_torch.env import env as env_lib
    from rlgpuschedule_tpu_torch.serve import InferenceEngine, pad_batch

    # the request pool: rows the greedy policy reaches in 64 clusters
    sub = type(traces)(*(x[:64] for x in traces))
    rows_obs, rows_mask = [], []
    with torch.inference_mode():
        state, ts = env_lib.reset(env_params, sub)
        for _ in range(5):
            rows_obs.append(ts.obs.cpu().numpy())
            rows_mask.append(ts.action_mask.cpu().numpy())
            a = policy_decision(policy, ts.obs, ts.action_mask)
            state, ts = env_lib.vec_step(env_params, state, sub, a)
    obs = np.concatenate(rows_obs)
    mask = np.concatenate(rows_mask)

    engine = InferenceEngine(policy, max_bucket=256, device=dev)
    warmed = engine.warmup(obs[0], mask[0])
    latency, loose = {}, 0
    for bucket, sizes in BUCKETS.items():
        lat = []
        for n in sizes:
            rows = np.arange(n) * 7 % obs.shape[0]
            got, b = engine.decide(obs[rows], mask[rows])
            if b != bucket:
                raise SystemExit(f"{n} requests went to bucket {b}")
            with torch.inference_mode():
                o = torch.from_numpy(obs[rows]).to(dev)
                m = torch.from_numpy(mask[rows]).to(dev)
                padded = policy_decision(
                    policy,
                    torch.from_numpy(pad_batch(obs[rows], b)).to(dev),
                    torch.from_numpy(pad_batch(mask[rows], b, True)).to(dev))
                logits, _ = policy(o, m)
            if not np.array_equal(got, padded.cpu().numpy()[:n]):
                raise SystemExit(f"bucket {b}, {n} requests: served actions "
                                 f"differ from policy_decision")
            want = logits.argmax(-1).cpu().numpy()
            top2 = torch.topk(logits, 2, -1).values.cpu().numpy()
            margin = top2[:, 0] - top2[:, 1]
            off = got != want
            if (off & (margin >= MARGIN)).any():
                raise SystemExit(f"bucket {b}, {n} requests: padding changed "
                                 f"an action with margin >= {MARGIN}")
            loose += int(off.sum())
            for _ in range(LATENCY_REPS):
                t0 = time.perf_counter()
                engine.decide(obs[rows], mask[rows])
                lat.append((time.perf_counter() - t0) * 1e3)
        latency[str(bucket)] = {
            "sizes": list(sizes), "samples": len(lat),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}
    _line("requests", pool_rows=int(obs.shape[0]), warmed=list(warmed),
          dtype="bfloat16", decide_latency=latency,
          unpadded_mismatches_below_margin=loose)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import build_env_params
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": []}), flush=True)

    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    windows, traces = fleet_windows(cfg, N_CLUSTERS, device="cuda")
    policy = fleet_phase(torch, cfg, env_params, traces, "cuda")
    profile_phase(torch, env_params, traces, policy)
    compare_phase(torch, cfg, env_params, windows, "cuda")
    request_phase(torch, env_params, traces, policy, "cuda")
    _line("done", total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
