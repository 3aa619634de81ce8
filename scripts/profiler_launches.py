"""What torch.profiler records of the port's kernel launches, by launch API.

Run on a machine with a card, from the checkout's root:

    python3 scripts/profiler_launches.py [--out chiprun_out/profiler_launches]

1. Versions: Python, torch, its CUDA, the driver, the card's name and
   power limit (`nvidia-smi`).
2. A probe kernel built from the source below (nvcc, `build/probe/`),
   launched through each launch API (`<<<>>>`, `cudaLaunchKernel`,
   `cudaLaunchCooperativeKernel`, `cudaLaunchKernelExC` with and without
   `cudaLaunchAttributeCooperative`), 1 and 5 times in a profiled window,
   alone and after a PyTorch kernel in the same window, with CUDA activity
   alone and with CPU activity too: the launches the profiler's
   `key_averages()` counts, and those among Kineto's raw device events.
3. The port's launch-counting cases (one `k_mega` step, five `k_fused`
   calls, the fused linear's three wrapper calls with three students),
   after --sessions more profiling sessions of the probe in the same
   process: the kernel records the profiler keeps with the call alone in
   its window (a Chrome trace of it under --out), after a warm-up step of
   the profiler's schedule, and with 50 probe launches after the call; and
   the launches in a CUDA graph captured around the call
   (`tests/test_torch_cuda.py::launch_counts`).

Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe_kernel(float* x) {
  if (threadIdx.x == 0) x[blockIdx.x] += 1.f;
}
// how: 0 <<<>>>, 1 cudaLaunchKernel, 2 cudaLaunchCooperativeKernel,
// 3 cudaLaunchKernelExC with the cooperative attribute, 4 without it
extern "C" int probe_launch(float* x, int how, int grid, cudaStream_t s) {
  void* args[] = {&x};
  const void* fn = (const void*)probe_kernel;
  if (how == 0) {
    probe_kernel<<<grid, 32, 0, s>>>(x);
    return (int)cudaGetLastError();
  }
  if (how == 1) return (int)cudaLaunchKernel(fn, dim3(grid), dim3(32), args, 0, s);
  if (how == 2) return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(32), args, 0, s);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeCooperative;
  a[0].val.cooperative = 1;
  cfg.attrs = a;
  cfg.numAttrs = how == 3 ? 1 : 0;
  return (int)cudaLaunchKernelExC(&cfg, fn, args);
}
"""
HOWS = ("chevron", "cudaLaunchKernel", "cudaLaunchCooperativeKernel", "ExC_cooperative",
        "ExC_plain")


def versions() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvidia_smi": smi.strip(),
            "kind": torch.cuda.get_device_name(0)}


def build_probe() -> ctypes.CDLL:
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "probe.cu", out / "libprobe.so"
    src.write_text(PROBE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dll.probe_launch.restype = ctypes.c_int
    return dll


def _short(name: str) -> str:
    return name.split("(")[0].split("<")[0].replace("void ", "").strip()


def profile(fn, cpu: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def counts(prof) -> dict:
    """Kernel launches by short name: as key_averages() counts them, and
    among Kineto's raw device events (with how many have no CPU parent)."""
    cuda = torch.autograd.DeviceType.CUDA
    avg = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.count:
            avg[_short(e.key)] = avg.get(_short(e.key), 0) + e.count
    raw, orphan = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            n = _short(e.name())
            raw[n] = raw.get(n, 0) + 1
            if e.linked_correlation_id() == 0:
                orphan[n] = orphan.get(n, 0) + 1
    return {"key_averages": avg, "raw": raw, "raw_without_cpu_parent": orphan}


def probe_cases(dll) -> None:
    x = torch.zeros(132, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for how, name in enumerate(HOWS):
        for n in (1, 5):
            for after_torch in (False, True):
                for cpu in (False, True):
                    def fn():
                        if after_torch:
                            x.add_(1.0)
                        for _ in range(n):
                            rc = dll.probe_launch(x.data_ptr(), how, 132, stream)
                            assert rc == 0, (name, rc)
                    fn()  # warm
                    c = counts(profile(fn, cpu))
                    print(json.dumps({"probe": name, "launches": n, "after_torch": after_torch,
                                      "cpu_activity": cpu, **c}), flush=True)


def profile_variant(fn, variant: str, tail=None):
    """The profile of one fn() call: "default" (the window holds the call
    alone), "warmup" (a schedule whose warm-up step runs fn() once before
    the active step's call) or "tail" (the call, then `tail()` before the
    window's synchronise)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if variant == "warmup":
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return prof
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if variant == "tail":
            tail()
        torch.cuda.synchronize()
    return prof


def port_cases(out: Path, dll) -> None:
    import test_torch_cuda as tcu  # noqa: E402  (the card tests' helpers)
    from llm_qat_tpu_torch.ops import fused_decode as fd
    from llm_qat_tpu_torch.ops import fused_linear as fl
    from llm_qat_tpu_torch.ops import mega_decode as md

    dev = torch.device("cuda")
    mw, kw, h, c1, _main, _rec, _lengths = tcu._mega_case(dev, 4)
    qa, _pa = tcu._fused_gpt2(dev, 8, 0)
    a = tcu._fused_students(dev, 1024, 768, 768, 64, torch.bfloat16, seed=1)
    fwd_args = (a["xq"], a["xa"], a["w"], a["ws"], a["wz"], a["bq"], a["bias"],
                a["scalars"], True, 1e-5)
    dx_args = (a["g"], a["w"], a["ws"], a["wz"], a["bq"], a["scalars"], True, 1e-5)
    cases = {
        "mega_step": lambda: md.mega_decode_step_kv8(h, mw, *c1, 50, **kw),
        "fused_qkv_x5": lambda: [fd.fused_ln_qkv(*qa) for _ in range(5)],
        "fused_linear_students": lambda: (fl.fused_linear_fwd(*fwd_args),
                                          fl.fused_linear_bwd_dx(*dx_args),
                                          fl.fused_linear_bwd_dw(a["xq"], a["g"],
                                                                 a["scalars"])),
    }
    x = torch.zeros(132, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tail = lambda: [dll.probe_launch(x.data_ptr(), 0, 132, stream) for _ in range(50)]
    for name, fn in cases.items():
        fn()
        for variant in ("default", "warmup", "tail"):
            prof = profile_variant(fn, variant, tail)
            if variant == "default":
                trace = out / f"{name}.json"
                prof.export_chrome_trace(str(trace))
            c = counts(prof)
            c["key_averages"].pop("probe_kernel", None)
            print(json.dumps({"case": name, "variant": variant, **c}), flush=True)
        try:
            nodes = dict(tcu.launch_counts(fn))
        except Exception as e:  # the capture's own failure is a finding, not a crash
            nodes = {"error": repr(e)[:300]}
        print(json.dumps({"case": name, "graph_launches": nodes}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profiler_launches")
    ap.add_argument("--no-port", action="store_true", help="the probe kernel only")
    ap.add_argument("--sessions", type=int, default=0,
                    help="profiling sessions of the probe kernel before the port's cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_launches: needs a CUDA device")
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"versions": versions(), "env": {
        k: v for k, v in os.environ.items() if "CUPTI" in k or "KINETO" in k}}), flush=True)
    dll = build_probe()
    probe_cases(dll)
    x = torch.zeros(132, device="cuda")
    for _ in range(args.sessions):
        profile(lambda: dll.probe_launch(x.data_ptr(), 0, 132,
                                         torch.cuda.current_stream().cuda_stream), False)
    if not args.no_port:
        port_cases(out, dll)


if __name__ == "__main__":
    main()
