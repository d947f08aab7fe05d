// K15 liquid_sdf: the cell-centred liquid SDF from the "pallas" engine's
// slot table.
//
// Replaces no TPU kernel: the JAX package computes the SDF from its slot
// table with XLA (flipviscosity3d_tpu/ops/pallas_particles.py::
// liquid_sdf_from_fields), and the port ran it as plain PyTorch
// (ops/pallas_particles.py::table_fields, a relayout of the table into three
// slot-major (cap, n_cells) tensors, then ops/particle_grid.py::
// liquid_sdf_from_particles, a loop over the 27 cell offsets of about 14
// launches over (cap, n_cells) tensors each): ~400 launches and tens of GB
// of temporaries a substep at 256^3.
//
// What it computes: for every cell c of an (I, J, K) grid,
//   phi(c) = min(3dx, min over the particles p in the 3x3x3 cells around c
//                of |center(c) - p| - radius),
// neighbours outside the grid contributing nothing; then, with finalize,
// phi(c) = -dx/2 where phi(c) < dx/2 and solid(c) < 0. The table is
// (I, J, K, cap) float4 slots as K1 and K5 write them: (px, py, pz, 1) for
// the particles of in-cell rank 0 .. count-1, zeros after them. So a cell's
// occupied slots are a prefix, and the kernel reads a cell's slots up to its
// first empty one.
//
// What bounds it on the H100: bytes. The table is cap*16 B a cell (4.3 GB
// at 256^3 and cap 16), against 81 flops a particle (3 for each of its 27
// target cells); the cells' occupied prefixes and first empty slots are
// 0.84 GB of it on the bench pool at 256^3. Each slot has to leave device
// memory about once, not once for each of the 27 cells that read it.
//
// The design. A block of 512 threads owns 16 (j) x 32 (k) source columns,
// one thread each, and marches along i through a chunk of planes (the
// wrapper sizes it: _build.plane_chunk). The interior 14 x 30 columns are
// the block's target columns; the ring around them is the one-cell halo. A
// warp is one j row of 32 k.
// - Each step a thread reads the slots of its source cell (p, j, k), two
//   at a time (one 32-B sector), until the first empty one, and keeps for
//   each particle the 27 d^2 to the centres of the cells (p + oi, j + oj,
//   k + ok): the min over its particles of each, in registers.
// - The three oi fold in registers: a thread keeps the partial mins of
//   target planes p - 1, p and p + 1 of its column, and plane p - 1 is
//   complete after source plane p.
// - The nine (oj, ok) fold through shared memory: each thread writes its
//   nine mins for plane p - 1 to the target cells they belong to, one slot
//   per (oj, ok), so no two threads write one word and nothing is atomic.
//   After one __syncthreads each target thread takes the min of its nine
//   words, the root, the radius and the solid test, and writes phi. The
//   shared buffer is doubled, so one __syncthreads a step suffices.
// - Offsets into the table are 64-bit; the grid has fewer than 2^31 cells
//   (the wrapper checks).
//
// Rounding: the library is built with -fmad=false. Each d^2 is rounded as
// the plain version rounds it: u = ((s + 0.5) * dx) - p per axis for the
// source cell s, t = u + o * dx, d^2 = (tx * tx + ty * ty) + tz * tz, with
// dx the f32 the plain version multiplies by. Min is exact, and sqrt and
// the subtraction of the radius are monotonic, so taking the min over the
// 27 offsets before the root gives the bits of the plain version's min of
// roots; a NaN is kept, as torch.min and torch.minimum keep it. Empty slots
// (far away in the plain version's relayout) never win its min. So the
// result is torch.equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SK = 32;            // source columns of a block along k
constexpr int SJ = 16;            // source columns of a block along j
constexpr int NT = SK * SJ;       // threads of a block
constexpr int TK = SK - 2;        // target columns along k (the interior)
constexpr int TJ = SJ - 2;        // target columns along j
// blocks an SM holds at once (ops/pallas_particles.py::_SDF_BLOCKS_PER_SM):
// 64 registers a thread
constexpr int BLOCKS_PER_SM = 2;

struct Args {
  const float4* table;
  const float* solid;  // null without finalize
  float* phi;
  int I, J, K, cap, chunk;
  float dx, three_dx, radius, half_dx, neg_half_dx;
};

// the min that keeps a NaN of either side, as torch.minimum does
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// Fold particle q of a source cell centred at (cx, cy, cz) into m[oi + 1]
// [(oj + 1) * 3 + ok + 1], the mins of d^2 to the cell at offset o.
__device__ __forceinline__ void add_particle(const float4 q, float cx,
                                             float cy, float cz, float dx,
                                             float (&m)[3][9]) {
  const float ux = cx - q.x, uy = cy - q.y, uz = cz - q.z;
  const float tx[3] = {ux - dx, ux, ux + dx};
  const float ty[3] = {uy - dx, uy, uy + dx};
  const float tz[3] = {uz - dx, uz, uz + dx};
  float sx[3], sy[3], sz[3];
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    sx[n] = tx[n] * tx[n];
    sy[n] = ty[n] * ty[n];
    sz[n] = tz[n] * tz[n];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float sxy = sx[a] + sy[b];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        m[a][b * 3 + c] = nan_min(m[a][b * 3 + c], sxy + sz[c]);
    }
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    liquid_sdf_kernel(const Args a) {
  __shared__ float part[2][9][NT];
  const int tiles_k = (a.K + TK - 1) / TK, tiles_j = (a.J + TJ - 1) / TJ;
  int bx = (int)blockIdx.x;
  const int k0 = (bx % tiles_k) * TK;
  bx /= tiles_k;
  const int j0 = (bx % tiles_j) * TJ;
  bx /= tiles_j;
  const int ia = bx * a.chunk, ib = min(ia + a.chunk, a.I);
  const int t = (int)threadIdx.x;
  const int lj = t / SK, lk = t % SK;
  const int gj = j0 - 1 + lj, gk = k0 - 1 + lk;
  const bool col = gj >= 0 && gj < a.J && gk >= 0 && gk < a.K;
  const bool target = col && lj >= 1 && lj <= TJ && lk >= 1 && lk <= TK;
  const float cy = ((float)gj + 0.5f) * a.dx;
  const float cz = ((float)gk + 0.5f) * a.dx;
  const float4 empty = make_float4(0.f, 0.f, 0.f, 0.f);

  // m[0], m[1], m[2]: the partial mins of d^2 for target planes p - 1, p,
  // p + 1 of this column, by (oj, ok)
  float m[3][9];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 9; ++e) m[n][e] = __int_as_float(0x7f800000);

  for (int p = ia - 1; p <= ib; ++p) {
    if (col && p >= 0 && p < a.I) {
      const float4* s = a.table + (((int64_t)p * a.J + gj) * a.K + gk) *
                                      (int64_t)a.cap;
      const float cx = ((float)p + 0.5f) * a.dx;
      for (int r = 0; r < a.cap; r += 2) {
        const float4 q0 = __ldg(s + r);
        const float4 q1 = r + 1 < a.cap ? __ldg(s + r + 1) : empty;
        if (!(q0.w > 0.5f)) break;
        add_particle(q0, cx, cy, cz, a.dx, m);
        if (!(q1.w > 0.5f)) break;
        add_particle(q1, cx, cy, cz, a.dx, m);
      }
    }
    // target plane p - 1 has every contribution of this column
    const int tp = p - 1;
    if (tp >= ia) {
      float(*buf)[NT] = part[p & 1];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        const int dj = lj + e / 3 - 1, dk = lk + e % 3 - 1;
        if (dj >= 1 && dj <= TJ && dk >= 1 && dk <= TK)
          buf[e][dj * SK + dk] = m[0][e];
      }
      __syncthreads();
      if (target) {
        float d2 = buf[0][t];
#pragma unroll
        for (int e = 1; e < 9; ++e) d2 = nan_min(d2, buf[e][t]);
        float v = nan_min(a.three_dx, sqrtf(d2) - a.radius);
        const int64_t c = ((int64_t)tp * a.J + gj) * a.K + gk;
        if (a.solid && v < a.half_dx && __ldg(a.solid + c) < 0.f)
          v = a.neg_half_dx;
        a.phi[c] = v;
      }
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      m[0][e] = m[1][e];
      m[1][e] = m[2][e];
      m[2][e] = __int_as_float(0x7f800000);
    }
  }
}

}  // namespace

// table: (I, J, K, cap) float4 slots; solid: (I, J, K) f32, or null where
// phi is not finalized; phi: (I, J, K) f32 out. The f32 constants are the
// plain version's: dx, 3dx, radius, dx / 2 and -dx / 2, each rounded from
// the double on its own.
extern "C" int flip3d_liquid_sdf(const void* table, const void* solid,
                                 void* phi, int I, int J, int K, int cap,
                                 float dx, float three_dx, float radius,
                                 float half_dx, float neg_half_dx, int chunk,
                                 void* stream) {
  if (chunk < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.table = (const float4*)table;
  a.solid = (const float*)solid;
  a.phi = (float*)phi;
  a.I = I;
  a.J = J;
  a.K = K;
  a.cap = cap;
  a.chunk = chunk;
  a.dx = dx;
  a.three_dx = three_dx;
  a.radius = radius;
  a.half_dx = half_dx;
  a.neg_half_dx = neg_half_dx;
  const int64_t blocks = (int64_t)((I + chunk - 1) / chunk) *
                         ((J + TJ - 1) / TJ) * ((K + TK - 1) / TK);
  if (blocks == 0) return 0;
  liquid_sdf_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
