"""Writes wgmma_tf32.cuh: one wrapper per width N = 8, 16, ..., 128 of

    wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32

with A (64 x 8) from registers and B (N x 8, K-major) from shared memory.
PTX takes N as part of the instruction and lists all N / 2 accumulator
registers of a thread, so each width is its own asm statement.

    python3 deepctr_torch/csrc/gen_wgmma_tf32.py
"""

import os

MAX_NT = 16  # n8 tiles: N up to 128 (the towers use up to 64, dense_bwd.cu 128)

HEAD = """\
// Generated by gen_wgmma_tf32.py; do not edit.
//
// Wgmma<kNt>::mma(d, a, desc_b, scale_d): d = a . B (+ d where scale_d is
// not 0) for one warpgroup, with N = 8 * kNt. a: this thread's four TF32
// values of the 64 x 8 A tile, in mma.m16n8k8's A fragment order (warp w of
// the warpgroup holds rows 16w to 16w + 15). desc_b: the shared-memory
// descriptor of the N x 8 B tile, K-major. d: 4 * kNt floats, in
// mma.m16n8k8's accumulator order for each n8 tile j (d[4j] to d[4j + 3]).

#pragma once

#include <cstdint>

namespace tower {

template <int kNt>
struct Wgmma;
"""

TAIL = """
}  // namespace tower
"""


def variant(nt: int) -> str:
    n_out = 4 * nt
    outs = ", ".join(f"%{i}" for i in range(n_out))
    a = ", ".join(f"%{n_out + i}" for i in range(4))
    desc, scale = n_out + 4, n_out + 5
    out_ops = ", ".join(f'"+f"(d[{i}])' for i in range(n_out))
    return f"""
template <>
struct Wgmma<{nt}> {{
  __device__ __forceinline__ static void mma(float (&d)[{n_out}],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{8 * nt}k8.f32.tf32.tf32 "
        "{{{outs}}}, {{{a}}}, %{desc}, p, 1, 1;\\n}}\\n"
        : {out_ops}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def main() -> None:
    text = HEAD + "".join(variant(nt) for nt in range(1, MAX_NT + 1)) + TAIL
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wgmma_tf32.cuh")
    with open(path, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
