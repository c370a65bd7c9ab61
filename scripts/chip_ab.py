#!/usr/bin/env python3
"""Parent against change on one NVIDIA GPU, in turns.

    git archive <parent> | tar -x -C build/parent   # an ignored directory
    python3 scripts/chip_ab.py build/parent
    python3 scripts/chip_ab.py build/parent --finetune

Runs, in the order parent, change, change, parent and each tree in its
own process from its own root (so each builds and loads its own
kernels): four full-width f32 Wan2.1 serving forwards (batch 1, seq_len
32768, kernel backend, the plans of one forward with inline planning
given), three timed by the host clock around a synchronised forward (the
walls) and the fourth under torch.profiler (the forward kernel's device
time: the split kernel and its pre-pass, or the parent's f32-FMA
kernel); then three full-width Wan2.1 training steps through that tree's
`chip_smoke.phase_train` (kernel backend, bf16 compute, per-layer remat),
then three static Qwen3-1.7B prefill groups of 2 x 32,000 tokens through
the `ServingEngine` (kernel backend, decode-SLA), then four groups that
each take 16 static decode steps after their prefill: three timed by the
host clock (the decode steps' wall), the first of them with CUDA events
recorded right before and after each decode kernel launch call (the
split and combine kernels, or the parent's one kernel: the host's time
to issue the launch is inside the interval), the fourth under
torch.profiler (the decode kernels' device time a step). Last, the
decode kernel on the random C = 1 bf16 operands of `chip_smoke`'s phase
11, timed by CUDA events around replays of a CUDA graph of 20 calls (its
device time a call), and by the host clock over 200 eager calls without
a synchronisation (the host's cost to issue one).

With `--finetune` each run instead takes `examples_torch/finetune_dit`'s
`sla` mode at its 100m preset's widths and depth (batch 2, bf16 compute
over f32 masters, seeded random weights, kernel backend): 15 steps
through that tree's `chip_smoke._ft_train` (its own per-step launch
checks; the step walls' median, min and max after the first), 8 more
steps' walls, then one step under torch.profiler (its wall, device time
and busy share, the host's own time in the ops it ran, the SLA kernels'
device time, the top ops by the device time of their kernels and by
their own host time).

Prints one JSON line a run. Exits non-zero if a run failed. Compare the
two trees only within one call of this script.
"""
import json
import subprocess
import sys
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[1]
RUN = r'''
import json, re, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import sla_decode
from repro_torch.serving.engine import Request, ServingEngine
cs.phase_card()
cs.phase_build()
cfg, params = cs._main_model(seed=0)
from repro_torch.models import dit
from torch.profiler import ProfilerActivity, profile
rs = np.random.default_rng(1)
lat = torch.from_numpy(rs.standard_normal((1, 32768, cfg.patch_dim),
                                          dtype=np.float32)).cuda()
cond = torch.from_numpy(rs.standard_normal((1, cfg.cond_len, cfg.d_model),
                                           dtype=np.float32)).cuda()
tt = torch.full((1,), 0.6, device="cuda")
with torch.no_grad():
    _, plans = dit.forward(params, cfg, lat, tt, cond, torch.float32,
                           "kernel", return_plans=True)
    serve_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        dit.forward(params, cfg, lat, tt, cond, torch.float32, "kernel",
                    plans=plans)
        torch.cuda.synchronize()
        serve_walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dit.forward(params, cfg, lat, tt, cond, torch.float32, "kernel",
                    plans=plans)
        torch.cuda.synchronize()
dev = [e for e in prof.key_averages()
       if e.device_type == torch.autograd.DeviceType.CUDA]
fwd = [e for e in dev if re.search(r"sla_fwd\w*_kernel|split_kv_kernel",
                                   e.key)]
serve_kernel_ms = sum(e.self_device_time_total for e in fwd) / 1e3
serve_device_ms = sum(e.self_device_time_total for e in dev) / 1e3
serve_kernel_launches = sum(e.count for e in fwd)
del plans, lat, cond
torch.cuda.empty_cache()
train = cs.phase_train(cfg, params, False)
del params
torch.cuda.empty_cache()
lm_cfg, lm_params = cs._lm_model(seed=0)
eng = ServingEngine(lm_cfg, lm_params, batch_size=2, max_len=32768,
                    backend="kernel", decode_sla=True)
rs = np.random.default_rng(0)
prefill = []
for _ in range(3):
    reqs = [Request(rid=i, prompt=rs.integers(0, lm_cfg.vocab_size,
                                              size=32000).astype(np.int32),
                    max_new_tokens=2) for i in range(2)]
    before = eng.stats.prefill_s
    eng.run(reqs)
    prefill.append(eng.stats.prefill_s - before)


class Timed:
    """The decode kernels' library with CUDA events recorded right before
    and after each launch call."""

    def __init__(self, lib):
        self.lib, self.events = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.endswith("_launch"):
            return fn

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events.append((start, end))
            return out
        return call


def decode_group(steps=16):
    reqs = [Request(rid=i, prompt=rs.integers(0, lm_cfg.vocab_size,
                                              size=32000).astype(np.int32),
                    max_new_tokens=steps + 1) for i in range(2)]
    before = eng.stats.decode_s
    eng.run(reqs)
    return eng.stats.decode_s - before


lib = sla_decode._lib()
timed = Timed(lib)
sla_decode._lib = lambda: timed
decode_ms = [decode_group() / 16 * 1e3]
torch.cuda.synchronize()
launch_ms = [a.elapsed_time(b) for a, b in timed.events]
sla_decode._lib = lambda: lib
decode_ms += [decode_group() / 16 * 1e3 for _ in range(2)]
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    decode_group()
kern = [e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and re.search(r"sla_decode\w*_kernel", e.key)]


def graph_ms(fn, reps=20, replays=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


args, kw = cs._decode_operands(22, 1, torch.bfloat16, 300 * 64 + 32)
sla_decode.sla_decode(*args, **kw)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    sla_decode.sla_decode(*args, **kw)
host_us = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
print("AB " + json.dumps(dict(
    serve_fwd_walls=serve_walls,
    serve_fwd_kernel1_ms=serve_kernel_ms,
    serve_fwd_kernel1_launches=serve_kernel_launches,
    serve_fwd_device_ms=serve_device_ms,
    train_walls=[r["wall_s"] for r in train["steps"]],
    peak_gib=train["peak_gib"], prefill_s=prefill,
    decode_ms_per_step=decode_ms,
    decode_launches=len(launch_ms),
    decode_launch_event_ms_mean=sum(launch_ms) / len(launch_ms),
    profiled_kernel_ms_per_step=sum(e.self_device_time_total
                                    for e in kern) / 16e3,
    profiled_kernel_launches=sum(e.count for e in kern),
    random_row_c1_bf16_graph_ms=graph_ms(
        lambda: sla_decode.sla_decode(*args, **kw)),
    random_row_c1_bf16_host_us_per_call=host_us)), flush=True)
'''


RUN_FINETUNE = r'''
import json, re, sys, time
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from examples_torch import finetune_dit
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import dit
cs.phase_card()
cs.phase_build()
p = finetune_dit.PRESETS["100m"]
shape = ShapeConfig("dit", p["seq"], 2, "train")
cfg = finetune_dit.build("100m", "sla")
params = dit.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device=cs.DEV)
r = cs._ft_train("dit_finetune_sla", cfg, params, shape, 15, 1.5e-4, 1,
                 "sla")
walls, state = [], {"t": time.time()}


def on_step(s, loss):
    now = time.time()
    walls.append(now - state["t"])
    state["t"] = now


finetune_dit.train(cfg, params, shape, 8, 1.5e-4, 2, sla_mode="sla",
                   backend="kernel", on_step=on_step, log_every=50)
prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def on_prof(s, loss):
    torch.cuda.synchronize()
    if s == 1:
        prof.__enter__()
        state["t0"] = time.time()
    elif s == 2:
        state["wall"] = time.time() - state["t0"]
        prof.__exit__(None, None, None)


finetune_dit.train(cfg, params, shape, 3, 1.5e-4, 3, sla_mode="sla",
                   backend="kernel", on_step=on_prof, log_every=50)
ka = prof.key_averages()
cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
dev = [e for e in ka if e.device_type == cuda and not e.is_user_annotation]
host = [e for e in ka if e.device_type == cpu]
dev_s = sum(e.self_device_time_total for e in dev) / 1e6
print("AB " + json.dumps(dict(
    step_s_median=r["step_s_median"], step_s_min=r["step_s_min"],
    step_s_max=r["step_s_max"], first_step_s=r["first_step_s"],
    launches_per_step=r["launches_per_step"], more_step_walls=walls[1:],
    profiled_wall_s=state["wall"], profiled_device_s=dev_s,
    busy=dev_s / state["wall"],
    host_op_s=sum(e.self_cpu_time_total for e in host) / 1e6,
    host_ops=sum(e.count for e in host),
    sla_kernels_ms={re.search(r"sla_\w+(<\d+>)?", e.key).group(0):
                    e.self_device_time_total / 1e3
                    for e in dev if re.search(r"sla_\w+_kernel", e.key)},
    top_device_ms=[(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in sorted(host, key=lambda e:
                                   -e.self_device_time_total)[:8]],
    top_host_ms=[(e.key, e.self_cpu_time_total / 1e3, e.count)
                 for e in sorted(host, key=lambda e:
                                 -e.self_cpu_time_total)[:8]])), flush=True)
'''


def main(argv) -> int:
    finetune = "--finetune" in argv
    argv = [a for a in argv if a != "--finetune"]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(argv[0]).resolve(), "change": CHANGE}
    failed = False
    for name in ("parent", "change", "change", "parent"):
        p = subprocess.run([sys.executable, "-c",
                            RUN_FINETUNE if finetune else RUN],
                           cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in p.stdout.splitlines() if x.startswith("AB ")]
        res = dict(tree=name, rc=p.returncode,
                   **(json.loads(line[0][3:]) if line else {}))
        if p.returncode or not line:
            failed = True
            res["tail"] = (p.stdout + p.stderr)[-3000:]
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
