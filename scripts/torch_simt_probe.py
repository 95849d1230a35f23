"""Probe what bounds the CUDA-core ("simt") flash kernel on the card.

    PYTHONPATH=src python scripts/torch_simt_probe.py [lds] [ffma] [layouts]
        [ablate]

With no argument it runs all four, each printing per line:

- ``lds``: SM clocks per warp's 16-byte shared load (``ld.shared.v4``) by
  the count and arrangement of distinct addresses among its 32 lanes.
- ``ffma``: TFLOP/s of a register-only FFMA loop, and of micro-tile
  patterns (TM x TN accumulators over float4 operands, as dot4 chains
  or outer products) from registers.
- ``layouts``: the tiled kernel of ``csrc/flash_attention.cu`` compiled
  at other ``Tile`` shapes (q rows a warp, lanes along S's rows, lanes
  along the output's rows) beside the instantiated ones, timed at
  granite-8b's f32 attention, (1, 32, 4096, 128) causal, and gemma-7b's
  (1, 16, 4096, 256), each held against the plain version.
- ``ablate``: copies of the source with one part of the kv step taken
  out (S, P.V, the step's barrier, the copies of the next tile, exp),
  timed at (128, 32) on granite's shape; their results are wrong and
  only their times are read.

The card's name and power limit come first.  Sources and libraries go
under ``build/simt_probe/``; the kernel's own source is not touched.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "simt_probe"
KERNEL = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"

LDS = r'''
template <int PAT>
__global__ void __launch_bounds__(256) lds(float* out, int iters) {
  __shared__ float4 sm[1024];
  for (int i = threadIdx.x; i < 1024; i += 256) sm[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int idx = PAT == 0 ? 0 : PAT == 1 ? (lane / 8) * 33
                : PAT == 2 ? (lane % 4) * 33 : PAT == 3 ? (lane % 8) * 33
                : PAT == 4 ? (lane / 4) * 33 : PAT == 5 ? (lane % 16) * 33
                : lane;
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm);
  float acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const unsigned a = base + 16u * ((idx + u * 97 + w * 7 + it * 13) & 1023);
      float x0, x1, x2, x3;
      asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                   : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3) : "r"(a));
      acc += x0;
    }
  }
  if (acc == 1234.5f) out[threadIdx.x] = acc;
}
template <int TM, int TN, int OUTER>
__global__ void __launch_bounds__(256, 1) tile(float* out, int iters) {
  float4 a[TM], b[TN];
  for (int i = 0; i < TM; ++i) a[i] = make_float4(threadIdx.x * 1e-3f + i, 1e-3f, 2e-3f, 3e-3f);
  for (int i = 0; i < TN; ++i) b[i] = make_float4(threadIdx.x * 2e-3f + i, 1e-3f, 2e-3f, 3e-3f);
  float s[TM][TN] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int k = 0; k < (OUTER ? 4 : 1); ++k)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            if (OUTER) {
              const float av = k == 0 ? a[i].x : k == 1 ? a[i].y : k == 2 ? a[i].z : a[i].w;
              const float bv = k == 0 ? b[n].x : k == 1 ? b[n].y : k == 2 ? b[n].z : b[n].w;
              s[i][n] = fmaf(av, bv, s[i][n]);
            } else {
              float x = s[i][n];
              x = fmaf(a[i].x, b[n].x, x); x = fmaf(a[i].y, b[n].y, x);
              x = fmaf(a[i].z, b[n].z, x); x = fmaf(a[i].w, b[n].w, x);
              s[i][n] = x;
            }
          }
      a[c % TM].x += 1e-7f;
      b[c % TN].y += 1e-7f;
    }
  }
  float t = 0;
  for (int i = 0; i < TM; ++i) for (int n = 0; n < TN; ++n) t += s[i][n];
  if (t == 1234.5f) out[threadIdx.x] = t;
}
__global__ void __launch_bounds__(256) ffma(float* out, int iters) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 64; ++u) a[u % 16] = fmaf(a[u % 16], 0.999f, 1e-4f);
  }
  float s = 0;
  for (int i = 0; i < 16; ++i) s += a[i];
  if (s == 1234.5f) out[threadIdx.x] = s;
}
#define T(TM, TN, O) tile<TM, TN, O><<<blocks, 256>>>(out, iters)
extern "C" int run(int which, float* out, int iters, int blocks) {
  switch (which) {
    case 0: lds<0><<<blocks, 256>>>(out, iters); break;
    case 1: lds<1><<<blocks, 256>>>(out, iters); break;
    case 2: lds<2><<<blocks, 256>>>(out, iters); break;
    case 3: lds<3><<<blocks, 256>>>(out, iters); break;
    case 4: lds<4><<<blocks, 256>>>(out, iters); break;
    case 5: lds<5><<<blocks, 256>>>(out, iters); break;
    case 6: lds<6><<<blocks, 256>>>(out, iters); break;
    case 10: ffma<<<blocks, 256>>>(out, iters); break;
    case 11: T(4, 4, 0); break;
    case 12: T(4, 4, 1); break;
    case 13: T(8, 8, 0); break;
    case 14: T(8, 8, 1); break;
    case 15: T(4, 8, 0); break;
  }
  return (int)cudaGetLastError();
}
'''
LDS_CASES = {0: "1 address", 1: "4, one a quarter-warp",
             2: "4, the same in each quarter", 3: "8, the same in each quarter",
             4: "8, two a quarter", 5: "16", 6: "32 consecutive"}
TILE_CASES = {11: ("4 x 4 dot4", 16), 12: ("4 x 4 outer", 16),
              13: ("8 x 8 dot4", 64), 14: ("8 x 8 outer", 64),
              15: ("4 x 8 dot4", 32)}

# the tiled kernel's Tile shapes: the instantiated ones first
LAYOUTS = [(128, 32, 128, 16, 4, 2), (64, 32, 128, 16, 4, 2),
           (64, 64, 128, 16, 4, 2), (64, 32, 256, 8, 2, 2),
           (128, 32, 128, 16, 4, 4), (128, 32, 128, 16, 2, 2),
           (128, 32, 128, 16, 8, 2), (64, 32, 256, 8, 4, 2)]
# one part of the kv step taken out, each a (text, replacement) pair
ABLATE = {
    "none": [],
    "no S": [("    for (int c = 0; c < D; c += G) {",
              "    for (int c = 0; c < (ki < 0 ? D : 0); c += G) {")],
    "no P.V": [("    for (int j = 0; j < C::BKVW; j += G) {",
                "    for (int j = 0; j < (ki < 0 ? C::BKVW : 0); j += G) {")],
    "no barrier": [("    __syncthreads();   // tile ki whole; every warp done"
                    " with tile ki-1\n", "")],
    "no copies": [("        copy_tile<C>(kn, kg + next, d);\n"
                   "        copy_tile<C>(vn, vg + next, d);", "")],
    "no exp": [("        float p = exp2f(s[i][n] - mn);",
                "        float p = s[i][n] - mn;"),
               ("      const float alpha = exp2f(m[i] - mn);",
                "      const float alpha = m[i] - mn;")],
}
LAUNCHER = '''
namespace {
template <class C>
int probe_launch(const float* q, const float* k, const float* v, float* out,
                 long long bh, int sq, int skv, int d, float scale) {
  auto* kernel = flash_attention_simt_kernel<float, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)bh, (unsigned)(sq / C::BQ));
  kernel<<<grid, THREADS, C::SMEM>>>(q, k, v, out, sq, skv, d, 1, skv - sq,
                                     scale);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int probe(int which, const float* q, const float* k,
                     const float* v, float* out, long long bh, int sq,
                     int skv, int d, float scale) {
  switch (which) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
'''


def build(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(source)
    so = cu.with_suffix(".so")
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {cu}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def timed_ms(fn, iters: int = 5, reps: int = 5) -> float:
    """Median of ``reps`` samples of ``iters`` back-to-back calls, ms a
    call, CUDA events, after two calls of warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        samples.append(a.elapsed_time(b) / iters)
    return sorted(samples)[len(samples) // 2]


def micro(parts: set) -> None:
    lib = build("micro", LDS)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int]
    out = torch.zeros(256, device="cuda")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if "lds" in parts:
        iters, blocks = 2000, sms * 8
        for which, name in LDS_CASES.items():
            ms = timed_ms(lambda: lib.run(which, out.data_ptr(), iters,
                                          blocks), iters=1, reps=3)
            loads = blocks * 8 * iters * 16
            print(f"lds  {name:28s}: {ms / 1e3 * clock * sms / loads:.3f} "
                  f"SM clocks a warp load (at {clock / 1e6:.0f} MHz)",
                  flush=True)
    if "ffma" in parts:
        iters = 20000
        ms = timed_ms(lambda: lib.run(10, out.data_ptr(), iters, sms * 8),
                      iters=1, reps=3)
        print(f"ffma register-only loop: {sms * 8 * 256 * iters * 128 / ms / 1e9:.1f}"
              " TFLOP/s", flush=True)
        iters = 2000
        for which, (name, n) in TILE_CASES.items():
            ms = timed_ms(lambda: lib.run(which, out.data_ptr(), iters, sms),
                          iters=1, reps=3)
            flops = sms * 256 * iters * 8 * n * 4 * 2
            print(f"ffma {name:10s} from registers: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def attention(lib, which: int, q, k, v) -> torch.Tensor:
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    err = lib.probe(which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b * h, sq, k.shape[2], d, fa._scale(d))
    if err:
        raise SystemExit(f"probe launch {which} failed: cudaError_t {err}")
    return out


def kernel_lib(name: str, source: str, tiles: list) -> ctypes.CDLL:
    cases = "\n".join(
        f"    case {i}: return probe_launch<Tile<{', '.join(map(str, t))}>>"
        "(q, k, v, out, bh, sq, skv, d, scale);" for i, t in enumerate(tiles))
    lib = build(name, source + LAUNCHER % cases)
    lib.probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_float]
    return lib


def inputs(heads: int, seq: int, d: int, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((1, heads, seq, d), generator=gen, device="cuda")
            for _ in range(3)]


def layouts() -> None:
    lib = kernel_lib("layouts", KERNEL.read_text(), LAYOUTS)
    big = {128: inputs(32, 4096, 128), 256: inputs(16, 4096, 256)}
    for i, t in enumerate(LAYOUTS):
        small = inputs(3, 256, t[2], seed=1)
        err = (attention(lib, i, *small) - fa.plain(*small)).abs().max()
        ms = timed_ms(lambda: attention(lib, i, *big[t[2]]))
        print(f"layout (block_q, block_kv, D, q rows a warp, S lanes along "
              f"rows, output lanes along rows) {t}: {ms:.4f} ms, max abs err "
              f"{err.item():.2e}", flush=True)


def ablate() -> None:
    base = KERNEL.read_text()
    q, k, v = inputs(32, 4096, 128)
    for name, patches in ABLATE.items():
        src = base
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"ablation {name!r}: the source changed")
            src = src.replace(old, new)
        lib = kernel_lib("ablate_" + name.replace(" ", "_").replace(".", ""),
                         src, [LAYOUTS[0]])
        ms = timed_ms(lambda: attention(lib, 0, q, k, v))
        print(f"ablate {name:10s}: {ms:.4f} ms at {LAYOUTS[0][:3]}",
              flush=True)


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this probe needs a card",
              file=sys.stderr)
        return 1
    parts = set(argv) or {"lds", "ffma", "layouts", "ablate"}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          flush=True)
    if parts & {"lds", "ffma"}:
        micro(parts)
    if "layouts" in parts:
        layouts()
    if "ablate" in parts:
        ablate()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
