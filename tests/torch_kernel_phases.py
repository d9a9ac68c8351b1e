"""Where the two kernels past SuperGlue's resident ceilings spend their time,
on the card (not a test; needs one CUDA card, imports no JAX).

    python tests/torch_kernel_phases.py            # K3 global and K2 streamed phases
    python tests/torch_kernel_phases.py --k2-variants  # also K2 ring / division variants

Each part builds a copy of a kernel source from ``rspl_slam_tpu_torch/csrc``
with ``clock64`` stamps on thread 0 of the first CTA (the phases end at CTA,
cluster or grid barriers, so thread 0's clock is the CTA's), into a library
of its own under ``_smoke_work/phases/`` (git-ignored), and calls it through
the port's wrappers (``cuda_build._libs`` points at the copy for the call).
It prints one JSON line per shape: the kernel's CUDA-event ms with stamps on,
the per-phase cycles (K3: per iteration; K2: per CTA), the card's name and
power limit. ``--k2-variants`` times K2's streamed kernel with other ring
depths and chunk widths and with a true division in place of the
reciprocal product, in turns (A, B, ..., B, A), checked against the plain
version; and reports how many of its clusters the card holds at once.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "_smoke_work", "phases")

STAMP_HEADER = '''#include "common.cuh"
__device__ unsigned long long g_phase[16];
__device__ long long g_last;
#define STAMP(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && \\
    threadIdx.x == 0) { long long now = clock64(); if (k) g_phase[k] += now - g_last; \\
    g_last = now; } } while (0)
'''
STAMP_EXPORTS = '''
RSPL_EXPORT int phase_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
RSPL_EXPORT int phase_zero() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
'''

# (line of the source, stamp, before or after it): phase k is the time from
# the previous stamp to stamp k
K3_MARKS = [
    ("    for (int it = 0; it < iters; ++it, parity ^= 1) {\n", "STAMP(0);\n", "after"),
    ("      // 2. the band's column partials, one thread per column (two at once\n",
     "STAMP(1);\n", "before"),
    ("      cluster.sync();  // the cluster's band partials are visible to every CTA of it\n",
     "STAMP(2);\n", "before"),
    ("      cluster.sync();  // the cluster's band partials are visible to every CTA of it\n",
     "STAMP(3);\n", "after"),
    ("      // 4. the one grid-level barrier of the iteration\n", "STAMP(4);\n", "after"),
    ("      // 5. v of columns [j0, j1) from the group's cpg cluster partials (read\n",
     "STAMP(5);\n", "after"),
    ("      cluster.sync();  // every CTA holds the full v\n", "STAMP(6);\n", "before"),
    ("      cluster.sync();  // every CTA holds the full v\n", "STAMP(7);\n", "after"),
]
K3_PHASES = ["rows", "columns", "cluster_sync_1", "cluster_merge", "grid_barrier", "v",
             "cluster_sync_2"]

K2_MARKS = [
    ("  if constexpr (kStreamed) {\n    streamed_attention(", "if (kStreamed) STAMP(0);\n",
     "before"),
    ("    if (t == n) {  // the four key groups' (max, sum) of each row, merged in order\n",
     "if (t == n) STAMP(1);\n", "before"),
    ("  cp_async_wait_group<0>();  // the empty trailing groups\n", "STAMP(2);\n", "before"),
    ("  __syncthreads();  // this CTA is done with P and V: the region takes the MLP tiles\n",
     "if (kStreamed) STAMP(3);\n", "before"),
    ("  cluster.sync();  // all four heads' messages are in every CTA's sMsg\n",
     "if (kStreamed) STAMP(4);\n", "after"),
    ("  {  // hidden = ReLU((concat[x, msg] W1 + b1) * s1 + t1), columns [128 h, 128 h + 128)\n",
     "if (kStreamed) STAMP(5);\n", "before"),
    ("  {  // out = x + (hidden W2 + b2), columns [64 h, 64 h + 64)\n",
     "if (kStreamed) STAMP(6);\n", "before"),
    ("  // no CTA reads another's shared memory after the last cluster barrier\n",
     "if (kStreamed) STAMP(7);\n", "before"),
]
K2_PHASES = ["pass_1", "pass_2", "combine", "message_sync", "merge", "mlp_1", "mlp_2"]

# K2's occupancy: clusters of its streamed kernel the card holds at once
K2_OCCUPANCY = '''
RSPL_EXPORT int streamed_clusters(int smem, void* out) {
  const void* k = (const void*)layer_bf16_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HEADS, 64, 2);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters((int*)out, k, &cfg);
  return (int)e;
}
'''


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _stamped(src: str, marks) -> str:
    for line, stamp, where in marks:
        if line not in src:
            raise SystemExit(f"torch_kernel_phases: the source no longer has {line!r}")
        src = src.replace(line, line + stamp if where == "after" else stamp + line, 1)
    return src.replace('#include "common.cuh"\n', STAMP_HEADER, 1) + STAMP_EXPORTS


def _build(sources: dict) -> dict:
    """name -> source text, compiled in parallel like cuda_build.build_all;
    returns name -> (library, its compiler output)."""
    from rspl_slam_tpu_torch.ops import cuda_build

    os.makedirs(WORK, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = os.path.join(WORK, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.FLAGS, f"-I{cuda_build.CSRC}", "-o",
             os.path.join(WORK, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_kernel_phases: nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(os.path.join(WORK, f"lib{name}.so")), log)
    return libs


def _bind(lib, kernel_lib: str):
    """Give ``lib`` the port's signatures for ``kernel_lib``, so the wrappers
    call it as they call the real library."""
    from rspl_slam_tpu_torch.ops import cuda_build

    for fn, sig in cuda_build.SIGNATURES[kernel_lib].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = [cuda_build._CTYPE[c] for c in sig], ctypes.c_int
    err = getattr(lib, f"{kernel_lib}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p


def _event_ms(fn, n: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _phases(lib, names, per: float = 1.0) -> dict:
    h = (ctypes.c_ulonglong * 16)()
    lib.phase_read(h)
    return {name: h[k + 1] / per for k, name in enumerate(names)}


def k3_phases(card: str):
    """K3's global kernel at SuperGlue's plans past every cluster: cycles per
    iteration of each phase on CTA 0."""
    import torch

    from rspl_slam_tpu_torch.ops import cuda_build
    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc

    src = open(os.path.join(cuda_build.CSRC, "sinkhorn.cu")).read()
    lib, _ = _build({"sinkhorn_phases": _stamped(src, K3_MARKS)})["sinkhorn_phases"]
    _bind(lib, "sinkhorn")
    real = cuda_build.library("sinkhorn")
    gen = torch.Generator(device="cuda").manual_seed(0)
    iters = 100
    for B, M in ((1, 920), (1, 1024), (1, 2048), (4, 1024), (1, 4096)):
        S = torch.randn((B, M, M), generator=gen, device="cuda") * 3
        m = (torch.arange(M, device="cuda")[None] < M - M // 11).expand(B, M)
        Z0, mu, nu, _ = sk.build_problem(S, m, m, 1.0)
        cuda_build._libs["sinkhorn"] = lib
        try:
            lib.phase_zero()
            skc._launch_global(Z0, mu, nu, iters)
            torch.cuda.synchronize()
            per_it = _phases(lib, K3_PHASES, per=iters * ((B + skc.global_clusters("cuda") - 1)
                                                          // skc.global_clusters("cuda")))
            stamped_ms = _event_ms(lambda: skc._launch_global(Z0, mu, nu, iters))
        finally:
            cuda_build._libs["sinkhorn"] = real
        plan = skc.grid_plan(B, M + 1, M + 1, skc.global_clusters("cuda"))
        print(json.dumps({"kernel": "sinkhorn_global", "card": card, "shape": [B, M + 1, M + 1],
                          "iters": iters, "grid_plan": plan._asdict(),
                          "stamped_ms": stamped_ms,
                          "ms": _event_ms(lambda: skc._launch_global(Z0, mu, nu, iters)),
                          "cycles_per_iteration_cta0": per_it,
                          "total_cycles_per_iteration": sum(per_it.values())}), flush=True)


def _random_layer(seed: int = 0):
    rng = np.random.default_rng(seed)
    C = 256

    def w(a, b):
        return (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)

    layer = {n: {"w": w(C, C), "b": (0.1 * rng.standard_normal(C)).astype(np.float32)}
             for n in ("q", "k", "v", "merge")}
    layer["mlp"] = [{"w": w(2 * C, 2 * C), "b": np.zeros(2 * C, np.float32),
                     "bn_scale": np.ones(2 * C, np.float32),
                     "bn_shift": np.zeros(2 * C, np.float32)},
                    {"w": w(2 * C, C), "b": np.zeros(C, np.float32),
                     "bn_scale": np.ones(C, np.float32), "bn_shift": np.zeros(C, np.float32)}]
    return layer


def _k2_variants() -> dict:
    """Source substitutions of K2's streamed kernel: the ring (chunk width,
    stages) and a true division in place of the reciprocal product."""
    return {
        "ck64_s4": [("constexpr int CK = 128;", "constexpr int CK = 64;"),
                    ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
        "ck64_s3": [("constexpr int CK = 128;", "constexpr int CK = 64;"),
                    ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
        "division": [("        rinv[hr] = 1.f / s;\n", "        rinv[hr] = s;\n"),
                     ("expf(l[jj][tile][2 * hr] - rmax[hr]) * rinv[hr]",
                      "expf(l[jj][tile][2 * hr] - rmax[hr]) / rinv[hr]"),
                     ("expf(l[jj][tile][2 * hr + 1] - rmax[hr]) * rinv[hr]",
                      "expf(l[jj][tile][2 * hr + 1] - rmax[hr]) / rinv[hr]")],
    }


def k2_phases(card: str, variants: bool):
    """K2's streamed kernel on stacked (2, K, 256) cross layers: the cycles of
    each phase on CTA 0; with ``variants``, the variants' event ms in turns."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac
    from rspl_slam_tpu_torch.ops import cuda_build

    src = open(os.path.join(cuda_build.CSRC, "superglue_layer.cu")).read()
    sources = {"layer_phases": _stamped(src, K2_MARKS), "layer": src + K2_OCCUPANCY}
    if variants:
        for name, subs in _k2_variants().items():
            text = src
            for a, b in subs:
                if a not in text:
                    raise SystemExit(f"torch_kernel_phases: the source no longer has {a!r}")
                text = text.replace(a, b)
            sources[name] = text
    libs = _build(sources)
    for lib, _ in libs.values():
        _bind(lib, "superglue_layer")
    occ = (ctypes.c_int * 1)()
    err = libs["layer"][0].streamed_clusters(ac.bf16_streamed_smem_bytes(), occ)
    print(json.dumps({"kernel": "superglue_layer_streamed", "card": card,
                      "smem_bytes": ac.bf16_streamed_smem_bytes(),
                      "clusters_held_at_once": occ[0] if err == 0 else None,
                      "occupancy_error": err}), flush=True)
    real = cuda_build.library("superglue_layer")
    layer = ac.pack_layer(_random_layer(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol, atol = 2.0 ** -8, 4e-3
    try:
        for K in (752, 960, 1024, 2048):
            x = torch.randn((2, K, 256), generator=gen, device="cuda")
            masks = torch.arange(K, device="cuda")[None] < torch.tensor(
                [[K], [K - K // 6]], device="cuda")
            sc = ac.layer_scratch(x, masks, torch.bfloat16)
            ref = ac.superglue_layer_plain(x, masks, layer, True, compute_dtype=torch.bfloat16)

            def run():
                return ac._launch_layer(x, masks, layer, True, 4, torch.bfloat16, sc, True)

            lib = libs["layer_phases"][0]
            cuda_build._libs["superglue_layer"] = lib
            lib.phase_zero()
            run()
            torch.cuda.synchronize()
            line = {"kernel": "superglue_layer_streamed", "card": card, "shape": [2, K, 256],
                    "clusters": 2 * -(-K // ac.ROWS),
                    "cycles_cta0": _phases(lib, K2_PHASES)}
            if variants:
                names = ["layer"] + list(_k2_variants())
                ms = {n: [] for n in names}
                for order in (names, names[::-1]):
                    for n in order:
                        cuda_build._libs["superglue_layer"] = libs[n][0]
                        got = run()
                        torch.cuda.synchronize()
                        ok = bool(((got - ref).abs() <= rtol * ref.abs() + atol).all())
                        ms[n].append((_event_ms(run, 20), ok))
                line["variants_ms_ok"] = ms
            else:
                cuda_build._libs["superglue_layer"] = libs["layer"][0]
                line["ms"] = _event_ms(run, 20)
            print(json.dumps(line), flush=True)
    finally:
        cuda_build._libs["superglue_layer"] = real


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    k3_phases(card)
    k2_phases(card, "--k2-variants" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
