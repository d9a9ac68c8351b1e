"""Where the kernels past SuperGlue's resident ceilings, and K2's f32 mode,
spend their time, on the card (not a test; needs one CUDA card, imports no
JAX).

    python tests/torch_kernel_phases.py            # K3 global and K2 streamed phases
    python tests/torch_kernel_phases.py --k2-variants  # also K2 ring / division variants
    python tests/torch_kernel_phases.py --k2-f32   # K2's f32 layer kernel alone

Each part builds a copy of a kernel source from ``rspl_slam_tpu_torch/csrc``
with ``clock64`` stamps on thread 0 of the first CTA (the phases end at CTA,
cluster or grid barriers, so thread 0's clock is the CTA's), into a library
of its own under ``_smoke_work/phases/`` (git-ignored), and calls it through
the port's wrappers (``cuda_build._libs`` points at the copy for the call).
It prints one JSON line per shape: the kernel's CUDA-event ms with stamps on,
the per-phase cycles (K3: per iteration; K2: per CTA), the card's name and
power limit. ``--k2-f32`` stamps K2's f32 layer kernel (3xTF32, K and V
streamed) on CTA 0 at (2, 400, 256) and (2, 1024, 256): pass 1, pass 2,
the exchange of the heads' messages, the merge, MLP 1 and MLP 2, in
cycles; and times it in turns beside six variants, each held to the plain
f32 version and to an f64 one (the layer and the QKV scratch), and each
run through ``match_pair`` at f32 (18 layers; its log plan against the
plain forward's): "chain"
(every product's MMAs accumulate in the running sum itself, no rounded
add), "kf2" (fragments of two k-steps, 6 MMAs per rounded add, where the
kernel takes one), "stages3" (a ring of three chunks), "unrolled" (the
GEMMs' k-loops unrolled whole), "ck128" (chunks of 128 keys, 32 per warp)
and "cvt_rna" (the TF32 rounding by the conversion instruction in place
of the kernel's integer add and mask);
first it prints the card's rate of independent mma.sync.m16n8k8 TF32 MMAs
and the latency of a dependent chain of them. ``--k2-variants`` times K2's streamed kernel with other ring
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

# K2's f32 layer kernel: its lines come after F32_SECTION in the source (the
# bf16 kernels before it share some of them)
F32_SECTION = "// ------------------------------------------------------------------ f32 mode\n"
K2_F32_MARKS = [
    ("  attention_f32(region, sMsg, QX + (size_t)set * Kq * 3 * C + h * DH,\n", "STAMP(0);\n",
     "before"),
    ("    if (t == n) {  // the four key groups' (max, sum) of each row, merged in order\n",
     "if (t == n) STAMP(1);\n", "before"),
    ("  cp_async_wait_group<0>();  // the empty trailing groups\n", "STAMP(2);\n", "before"),
    ("  cluster.sync();  // all four heads' messages are in every CTA's sMsg\n", "STAMP(3);\n",
     "after"),
    ("  {  // hidden = ReLU((concat[x, msg] W1 + b1) * s1 + t1), columns [128 h, 128 h + 128)\n",
     "STAMP(4);\n", "before"),
    ("  {  // out = x + (hidden W2 + b2), columns [64 h, 64 h + 64)\n", "STAMP(5);\n", "before"),
    ("  // no CTA reads another's shared memory after the last cluster barrier\n",
     "STAMP(6);\n", "before"),
]
K2_F32_PHASES = ["pass_1", "pass_2", "exchange", "merge", "mlp_1", "mlp_2"]
K2_F32_VARIANTS = {
    "chain": [("      float d[MT][2][4] = {};\n", "      auto& d = acc;\n"),
              ("""        add_fragment(acc[mt][0], d[mt][0]);
        add_fragment(acc[mt][1], d[mt][1]);
""", ""),
              ("    float d[JT_F32][4] = {};\n", "    auto& d = acc;\n"),
              ("    for (int tile = 0; tile < JT_F32; ++tile) add_fragment(acc[tile], d[tile]);\n",
               ""),
              ("          float d[4] = {};\n", "          auto& d = o[nb];\n"),
              ("          add_fragment(o[nb], d);\n", "")],
    "kf2": [("constexpr int KF_F32 = 1;", "constexpr int KF_F32 = 2;")],
    "stages3": [("constexpr int STAGES_F32 = 2;", "constexpr int STAGES_F32 = 3;")],
    "unrolled": [("#pragma unroll 1\n  for (int k0 = 0; k0 < KSTEPS; k0 += PF) {",
                  "#pragma unroll\n  for (int k0 = 0; k0 < KSTEPS; k0 += PF) {")],
    "ck128": [("constexpr int CK_F32 = 64; ", "constexpr int CK_F32 = 128;")],
    "cvt_rna": [("""  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
""", """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(a));
  return r;
""")],
}

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

# the card's mma.sync.m16n8k8 TF32 rate (8 independent accumulators per
# warp, 16 warps per SM) and the latency of one dependent chain
K2_F32_PROBE = '''
__global__ void mma_tf32_rate_kernel(int iters, float* out) {
  float acc[8][4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, 0x3f800000u, 0x3e000000u);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[0] = s;
}
__global__ void mma_tf32_chain_kernel(int iters, float* out, long long* cycles) {
  float acc[4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) mma_tf32(acc, a, 0x3f800000u, 0x3e000000u);
  const long long t1 = clock64();
  if (threadIdx.x == 0) { cycles[0] = t1 - t0; out[1] = acc[0]; }
}
RSPL_EXPORT int mma_tf32_rate(int ctas, int iters, void* out) {
  mma_tf32_rate_kernel<<<ctas, NT>>>(iters, (float*)out);
  return (int)cudaGetLastError();
}
RSPL_EXPORT int mma_tf32_chain(int iters, void* out, void* cycles) {
  mma_tf32_chain_kernel<<<1, 32>>>(iters, (float*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}
'''


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _stamped(src: str, marks, section: str | None = None) -> str:
    """``src`` with each mark's stamp before or after its line (the first
    one after ``section`` where given)."""
    head, tail = ("", src) if section is None else src.split(section, 1)
    for line, stamp, where in marks:
        if line not in tail:
            raise SystemExit(f"torch_kernel_phases: the source no longer has {line!r}")
        tail = tail.replace(line, line + stamp if where == "after" else stamp + line, 1)
    src = tail if section is None else head + section + tail
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


def k2_f32_phases(card: str):
    """K2's f32 layer kernel on stacked (2, K, 256) cross layers: the cycles
    of each phase on CTA 0, and the event ms with and without stamps."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac
    from rspl_slam_tpu_torch.ops import cuda_build

    src = open(os.path.join(cuda_build.CSRC, "superglue_layer.cu")).read()
    sources = {"layer_f32_phases": _stamped(src, K2_F32_MARKS, F32_SECTION),
               "layer": src + K2_F32_PROBE}
    for name, subs in K2_F32_VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"torch_kernel_phases: the source no longer has {a!r}")
            text = text.replace(a, b)
        sources[name] = text
    libs = _build(sources)
    for lib, _ in libs.values():
        _bind(lib, "superglue_layer")
    real = cuda_build.library("superglue_layer")
    probe = libs["layer"][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(2, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    iters = 4096
    rate_ms = _event_ms(lambda: probe.mma_tf32_rate(ctypes.c_int(2 * sms), ctypes.c_int(iters),
                                                    ctypes.c_void_p(out.data_ptr())), 5)
    probe.mma_tf32_chain(ctypes.c_int(iters), ctypes.c_void_p(out.data_ptr()),
                         ctypes.c_void_p(cyc.data_ptr()))
    torch.cuda.synchronize()
    mmas = 2 * sms * 8 * iters * 8  # CTAs x warps x iterations x accumulators
    print(json.dumps({"probe": "mma.sync.m16n8k8 tf32", "card": card, "sms": sms,
                      "tflops": mmas * 2048 / rate_ms * 1e-9,
                      "issue_cycles_per_mma_per_sm_partition_at_1.98GHz":
                          rate_ms * 1e-3 * 1.98e9 / (mmas / (4 * sms)),
                      "dependent_chain_cycles_per_mma": int(cyc.item()) / iters}), flush=True)
    layer = ac.pack_layer(_random_layer(), "cuda")

    def f64(lay):
        return {k: v.double() for k, v in lay.items() if not k.endswith(("_mma", "_tf32"))}

    layer64 = f64(layer)
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32 = torch.float32
    try:
        for K in (400, 1024):
            x = torch.randn((2, K, 256), generator=gen, device="cuda")
            masks = torch.arange(K, device="cuda")[None] < torch.tensor(
                [[K], [K - K // 6]], device="cuda")
            sc = ac.layer_scratch(x, masks, f32)
            ref = ac.superglue_layer_plain(x, masks, layer, True, compute_dtype=f32)
            # f32 mode rounds no operand, so on f64 tensors the plain version is f64
            ref64 = ac.superglue_layer_plain(x.double(), masks, layer64, True, compute_dtype=f32)
            qkv64 = x.double().reshape(-1, 256) @ layer64["wqkv"] + layer64["bqkv"]

            def run():
                return ac.superglue_layer(x, masks, layer, True, compute_dtype=f32, scratch=sc)

            lib = libs["layer_f32_phases"][0]
            cuda_build._libs["superglue_layer"] = lib
            lib.phase_zero()
            run()
            torch.cuda.synchronize()
            cycles = _phases(lib, K2_F32_PHASES)
            stamped_ms = _event_ms(run, 20)
            names = ["layer"] + list(K2_F32_VARIANTS)
            variants = {n: {"ms": []} for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    cuda_build._libs["superglue_layer"] = libs[n][0]
                    got = run()
                    torch.cuda.synchronize()
                    variants[n].update({
                        "max_abs_err": float((got - ref).abs().max()),
                        "max_abs_err_vs_f64": float((got.double() - ref64).abs().max()),
                        "qkv_max_abs_err_vs_f64": float((sc["qkv"].double() - qkv64).abs().max())})
                    variants[n]["ms"].append(_event_ms(run, 20))
            print(json.dumps({
                "kernel": "superglue_layer_f32", "card": card, "shape": [2, K, 256],
                "clusters": 2 * -(-K // ac.ROWS), "cycles_cta0": cycles,
                "total_cycles_cta0": sum(cycles.values()), "stamped_ms": stamped_ms,
                "plain_max_abs_err_vs_f64": float((ref.double() - ref64).abs().max()),
                "variants": variants}), flush=True)
        print(json.dumps({"kernel": "superglue_layer_f32", "card": card,
                          **_match_drift(libs, ["layer"] + list(K2_F32_VARIANTS))}), flush=True)
    finally:
        cuda_build._libs["superglue_layer"] = real


def _match_drift(libs, names) -> dict:
    """``match_pair`` at f32 through each variant of K2 (``SuperGlueConfig()``:
    18 layers, random weights, seed 0; random keypoints and unit
    descriptors, 400 against 400 (the stacked kernel) and 400 against 300
    (the two-set variant)): the max |difference| of the log plan from the
    plain forward's (``superglue_train.log_plan``, on the card) over valid
    entries, beside that plain forward's own spread (the same on the CPU).
    Errors of the layers grow through the 18 layers and the Sinkhorn."""
    import torch
    import torch.nn.functional as F

    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.models import superglue
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy, to_tensor_tree
    from rspl_slam_tpu_torch.ops import cuda_build
    from rspl_slam_tpu_torch.training import superglue_train

    cfg, f32 = SuperGlueConfig(), torch.float32
    params = superglue.init_params(cfg, 0)
    sg = superglue_from_numpy(params, cfg, "cuda")
    tree, tree_cpu = to_tensor_tree(params, "cuda"), to_tensor_tree(params, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def side(n):
        xy = torch.rand((1, n, 2), generator=gen, device="cuda") * torch.tensor(
            [cfg.image_width, cfg.image_height], device="cuda")
        desc = F.normalize(torch.randn((1, n, 256), generator=gen, device="cuda"), dim=-1)
        return (xy, torch.rand((1, n), generator=gen, device="cuda"), desc,
                torch.arange(n, device="cuda")[None] < n - n // 9)

    out = {"match_f32_log_plan_max_abs_err": {n: {} for n in names}, "plain_spread": {}}
    for pair, arrays in (("400x400", side(400) + side(400)), ("400x300", side(400) + side(300))):
        one = torch.ones((1, 1), dtype=torch.bool, device="cuda")
        sel = (torch.cat([arrays[3], one], 1)[:, :, None]
               & torch.cat([arrays[7], one], 1)[:, None, :])
        with torch.no_grad():
            ref = superglue_train.log_plan(tree, *arrays, cfg, f32)
            cpu = superglue_train.log_plan(tree_cpu, *(a.cpu() for a in arrays), cfg, f32)
        out["plain_spread"][pair] = float((cpu - ref.cpu()).abs()[sel.cpu()].max())
        for n in names:
            cuda_build._libs["superglue_layer"] = libs[n][0]
            got = superglue.match_pair(sg, *arrays, cfg, compute_dtype=f32).log_plan
            out["match_f32_log_plan_max_abs_err"][n][pair] = float((got - ref).abs()[sel].max())
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    if "--k2-f32" in argv:
        k2_f32_phases(card)
        return 0
    k3_phases(card)
    k2_phases(card, "--k2-variants" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
