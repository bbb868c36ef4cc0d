#!/usr/bin/env python3
"""Variants of the port's argkmin kernel, built and timed side by side on
one GPU.

Run from the root of the repository:

    python3 chip_variants.py [--phases] [SOURCE ...]

It builds ``sq_learn_tpu_torch/csrc/argkmin.cu`` as it stands, each
variant in ``VARIANTS`` (that source with a few constants edited) and
each SOURCE given (another version of the file, such as one taken from
the git history), one ``nvcc`` each, all at once, and prints each build's
registers and spills for ``argkmin_short``. Then, at the k-NN predict
shape (the last 10 000 rows of the MNIST-shaped surrogate as queries
against the first 60 000, 784 wide, k=7), each build must give the
committed build's indices and distances bit for bit, and is timed with
CUDA events in turns: one call of each build per round, ten rounds, the
median printed. Each build runs its own launch plan, cut to the tiles
and residency its library reports.

With ``--phases`` it also builds a copy of the committed source and of
each SOURCE with ``clock64()`` counters in ``argkmin_short``'s chunk
loop (the copy is made at run time and never kept) and prints the share
of the warps' cycles spent waiting at the chunk barrier, between the
barrier and the products (setting up or starting a later chunk's copies),
in the products and in the fold.

It needs one NVIDIA GPU and exits non-zero without one.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys

SOURCE = "sq_learn_tpu_torch/csrc/argkmin.cu"
BUILD = "sq_learn_tpu_torch/_build/variants"
K = 7
#: name -> (text, replacement) edits of the committed source
VARIANTS = {
    "two stages": [("kStages = 3;", "kStages = 2;")],
    "two stages, two blocks per SM": [("kStages = 3;", "kStages = 2;"),
                                      ("kShortBlocks = 1;",
                                       "kShortBlocks = 2;")],
    "64-column chunks": [("kBK = 32;", "kBK = 64;")],
    "64-column chunks, two stages": [("kBK = 32;", "kBK = 64;"),
                                     ("kStages = 3;", "kStages = 2;")],
}
#: (anchor, text put before it) of the phase counters; both the
#: committed loop and the first design's loop of argkmin_short have them
PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_phase[6];\n"),
    ("  for (int g = 0; g < total; ++g) {\n    cp_async_wait<kStages - 2>();",
     "  long long ph[4] = {0, 0, 0, 0};\n"
     "  const long long t_start = clock64();\n"),
    ("    cp_async_wait<kStages - 2>();\n    __syncthreads();  // chunk g",
     "    const long long c0 = clock64();\n"),
    ("    chunk_products(qs, qs + kBQ * kLd, tx, ty, acc",
     "    const long long c2 = clock64();\n    ph[1] += c2 - c1;\n"),
    ("    if (g % nchunks == nchunks - 1) {  // the tile is done",
     "    const long long c3 = clock64();\n    ph[2] += c3 - c2;\n"),
    ("    }\n  }\n  cp_async_wait<0>();\n",
     "      ph[3] += clock64() - c3;\n"),
]
PHASES = ("waiting at the barrier", "before the products",
          "products", "fold")


def instrument(src):
    """The source with clock64() counters in argkmin_short's loop."""
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"chip_variants: no unique probe point "
                             f"{anchor!r}")
        src = src.replace(anchor, text + anchor)
    src = re.sub(r"(__syncthreads\(\);  // chunk g[^\n]*\n)",
                 r"\1    const long long c1 = clock64();\n"
                 r"    ph[0] += c1 - c0;\n", src, count=1)
    src = src.replace(
        "  cp_async_wait<0>();\n  if (tx < k)",
        "  cp_async_wait<0>();\n  if ((threadIdx.x & 31) == 0) {\n"
        "    for (int p = 0; p < 4; ++p)\n"
        "      atomicAdd(&g_phase[p], (unsigned long long)ph[p]);\n"
        "    atomicAdd(&g_phase[4], (unsigned long long)(clock64() - "
        "t_start));\n    atomicAdd(&g_phase[5], 1ull);\n  }\n"
        "  if (tx < k)", 1)
    return src.replace('extern "C" {\n', '''extern "C" {
int sq_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[6] = {0, 0, 0, 0, 0, 0};
    return cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
''', 1)


def build_all(sources):
    """Compile {name: source text} at once; returns {name: library}."""
    from sq_learn_tpu_torch.ops import _build

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = os.path.join(BUILD, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"chip_variants: {name} did not build:\n{out}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "argkmin_short" in line)
        report = " ".join(line.split(":", 1)[-1].strip()
                          for line in lines[at + 2:at + 4])
        print(f"{name}: argkmin_short {report}", flush=True)
        libs[name] = ctypes.CDLL(os.path.abspath(so))
    return libs


class Search:
    """One library's k-nearest search at a fixed shape, called through
    its C entry point with its own launch plan and buffers."""

    def __init__(self, lib, T, tsq, Q, torch):
        from sq_learn_tpu_torch.ops.kernels import argkmin_plan

        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sq_argkmin.argtypes = [p, p, p] + [i] * 6 + [p] * 7
        lib.sq_argkmin_tiles.argtypes = [i] + [ctypes.POINTER(i)] * 3
        tiles = [i() for _ in range(3)]
        check(lib.sq_argkmin_tiles(K, *map(ctypes.byref, tiles)))
        self.tiles = tuple(t.value for t in tiles)
        nq, nt = Q.shape[0], T.shape[0]
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits, rows = argkmin_plan(nq, nt, K, n_sms, self.tiles)
        dev = Q.device

        def empty(n, dtype):
            return torch.empty(n, dtype=dtype, device=dev)

        self.out = (empty((nq, K), torch.int32), empty((nq, K), torch.float32))
        self.keep = [T, tsq, Q, empty(splits * nq * K, torch.float32),
                     empty(splits * nq * K, torch.int32),
                     empty(2 * nq * K, torch.float32),
                     empty(2 * nq * K, torch.int32), *self.out]
        self.plan = (splits, rows)
        self.args = ([t.data_ptr() for t in self.keep[:3]]
                     + [nt, nq, T.shape[1], K, splits, rows]
                     + [t.data_ptr() for t in self.keep[3:]])
        self.lib, self.torch = lib, torch

    def __call__(self):
        stream = self.torch.cuda.current_stream().cuda_stream
        check(self.lib.sq_argkmin(*self.args, stream))
        return self.out


def check(err):
    if err != 0:
        raise SystemExit(f"chip_variants: CUDA error {err}")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    phases = "--phases" in argv
    given = [a for a in argv if a != "--phases"]
    with open(SOURCE) as f:
        committed = f.read()
    sources = {"committed": committed}
    for name, edits in VARIANTS.items():
        text = committed
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"chip_variants: {name}: no unique {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    for path in given:
        with open(path) as f:
            sources[path] = f.read()
    if phases:
        for name in ["committed", *given]:
            sources[f"{name} with counters"] = instrument(sources[name])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build_all(sources)

    X, _ = synthetic_surrogate(70_000, 784, 10, seed=784)
    Xd = torch.from_numpy(X).cuda()
    T, Q = Xd[:60_000].contiguous(), Xd[60_000:].contiguous()
    tsq = torch.sum(T * T, dim=1)
    searches = {name: Search(lib, T, tsq, Q, torch)
                for name, lib in libs.items()}
    ref = [t.clone() for t in searches["committed"]()]
    for name, search in searches.items():
        out = search()
        torch.cuda.synchronize()
        same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        if not same:
            raise SystemExit(f"chip_variants: {name} differs from the "
                             f"committed build")
    times = {name: [] for name in searches}
    for _ in range(10):
        for name, search in searches.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            search()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, search in searches.items():
        print(f"{name}: tiles {search.tiles}, plan {search.plan}, median "
              f"{statistics.median(times[name]):.4f} ms (min "
              f"{min(times[name]):.4f}), bit-equal to the committed build",
              flush=True)
    for name, lib in libs.items():
        if not name.endswith(" with counters"):
            continue
        buf = (ctypes.c_ulonglong * 6)()
        check(lib.sq_phases(buf, 1))
        searches[name]()
        torch.cuda.synchronize()
        check(lib.sq_phases(buf, 0))
        shares = ", ".join(f"{phase} {100 * buf[p] / buf[4]:.2f} %"
                           for p, phase in enumerate(PHASES))
        print(f"{name}: {buf[4] / buf[5]:.0f} cycles per warp; {shares}",
              flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
