// K14 visc_build: the viscosity system build.
//
// Replaces no TPU kernel: the JAX package leaves the build to XLA
// (flipviscosity3d_tpu/solvers/viscosity.py::compute_volume_grids and
// ::build_viscosity_system), and the port ran it as plain PyTorch
// (solvers/viscosity.py::compute_volume_grids_ref and
// ::build_viscosity_system_ref): each of the 7 volume grids a
// volume_fraction_cube of 10 tetrahedra, each a sorting network, guarded
// divisions and selects over the whole grid, and each shifted read a
// full temporary grid: about 5,600 launches over full grids a build. It
// runs once a viscous substep.
//
// Three entry points, launched in this order by the two wrappers:
// - flip3d_visc_volumes (compute_volume_grids): the 7 control-volume
//   fraction grids of liquid_phi (I, J, K), each restricted to the liquid
//   mask dilated twice over the (I+1, J+1, K+1) node grid, in one launch;
// - flip3d_visc_assemble (build_viscosity_system): per face component the
//   row mask, the six premasked factors, the diagonal, the face volume
//   and the solid-Dirichlet velocity, the three components in one launch;
// - flip3d_visc_rhs (build_viscosity_system, after K13 has applied the
//   coupling to the Dirichlet velocities): the right-hand sides.
// Every grid may have any 3-D shape (the solve's, or the slab pipeline's
// halo'd slabs); reads outside a grid's own shape give 0, as the plain
// version's shifted reads and pads do.
//
// What bounds it on the H100: bytes. The volume kernel reads phi once and
// writes 7 grids; the assembly reads the viscosity, the volume grids, the
// velocities and the solid masks and writes 10 grids a component. The
// tetrahedron math is needed only where the dilated mask is set and a
// cube's 8 corners do not share a sign: near the liquid's surface.
//
// The volume kernel's design. A block of 256 threads owns a 32 (k) x 8 (j)
// tile of node columns and marches along i through a chunk of planes
// (solvers/viscosity.py::plane_chunk, shared with K13). Planes i-2 .. i+2
// of phi, with a 2-cell j/k halo, sit in a ring of 8 shared planes, 0
// outside phi's shape; the step that computes node plane i issues the
// loads of plane i+3 first and stores them after its work, so one
// __syncthreads a step suffices. A node computes:
// - the dilated mask: phi < 0 anywhere in the L1 ball of radius 2 (two
//   6-neighbour dilations; outside phi, 0 is not < 0);
// - whether phi is <= 0, or > 0, on its whole 3x3x3 block: then every
//   corner sample of every grid shares that sign, and each grid is 1 (or
//   0) without its corners;
// - otherwise, per grid, the 8 corner samples of its cube, phi itself on a half-cell
//   axis and the 2-point average on the others, the lower axis averaged
//   first (_ext_axis / _avg_axis); then 0 where the mask is unset, 1 where
//   every corner is <= 0, 0 where every corner is > 0, and the 10
//   tetrahedra otherwise.
// The assembly and RHS kernels give a thread one face of one component
// (blockIdx.y), k fastest, so every read and write is coalesced and the
// neighbours' reads hit L1 / L2.
//
// Rounding: the library is built with -fmad=false and every expression
// keeps the plain version's order, each product and sum rounded on its
// own. Two of the plain version's ops are matched as torch runs them on
// the card: the division of a tensor by the Python scalar 12.0 is a
// product with the f32 reciprocal (the wrapper passes 1/12 rounded to
// f32), and torch.minimum / maximum return a NaN operand, else fminf /
// fmaxf. The fast paths give the full sum's bits: 12 ones sum to 12
// exactly, times the same reciprocal, and 10 zeros to 0. So every output
// is bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;                        // k columns of a tile
constexpr int TJ = 8;                         // j rows of a tile
constexpr int NT = TK * TJ;                   // threads of a block
constexpr int H = 2;                          // halo: the dilation's reach
constexpr int SK = TK + 2 * H;                // shared row
constexpr int SJ = TJ + 2 * H;                // shared rows
constexpr int PLANE = SJ * SK;                // shared cells of a plane
constexpr int LOADS = (PLANE + NT - 1) / NT;  // of them a thread loads
constexpr int RING = 8;                       // shared planes
// blocks an SM holds at once (solvers/viscosity.py::_BLOCKS_PER_SM)
constexpr int BLOCKS_PER_SM = 4;
constexpr int GRIDS = 7;

struct VolArgs {
  const float* phi;
  float* out[GRIDS];
  // per grid, the axes on which it samples corner phi as a 2-point average
  // (bit 0: i, bit 1: j, bit 2: k), phi itself on the others; a grid is
  // one longer than phi on its averaged axes
  int avg[GRIDS];
  int I, J, K;  // phi's shape; the nodes are (I+1, J+1, K+1)
  int chunk;
  float inv12;  // 1/12 rounded to f32
};

// the ring slot of plane p >= -H
__device__ __forceinline__ int slot(int p) { return (p + H) & (RING - 1); }

// torch.minimum / torch.maximum on the card
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/levelset.py::_safe_div
__device__ __forceinline__ float safe_div(float n, float d) {
  return n / (d == 0.f ? 1.f : d);
}

// _sorted_tet_fraction: a the lone-signed corner
__device__ __forceinline__ float sorted_tet(float a, float b, float c,
                                            float d) {
  return safe_div(a * a * a, (a - b) * (a - c) * (a - d));
}

// _sorted_prism_fraction: p0, p1 < 0 <= p2, p3
__device__ __forceinline__ float sorted_prism(float p0, float p1, float p2,
                                              float p3) {
  const float a = safe_div(p0, p0 - p2);
  const float b = safe_div(p0, p0 - p3);
  const float c = safe_div(p1, p1 - p3);
  const float d = safe_div(p1, p1 - p2);
  return a * b * (1.f - d) + b * (1.f - c) * d + c * d;
}

// volume_fraction_tet: _sort4's five compare-swaps, then its cases
__device__ __forceinline__ float tet(float a, float b, float c, float d) {
  float t;
  t = tmin(a, b); b = tmax(a, b); a = t;
  t = tmin(c, d); d = tmax(c, d); c = t;
  t = tmin(a, c); c = tmax(a, c); a = t;
  t = tmin(b, d); d = tmax(b, d); b = t;
  t = tmin(b, c); c = tmax(b, c); b = t;
  if (d <= 0.f) return 1.f;
  if (c <= 0.f) return 1.f - sorted_tet(d, c, b, a);
  if (b <= 0.f) return sorted_prism(a, b, c, d);
  if (a <= 0.f) return sorted_tet(a, b, c, d);
  return 0.f;
}

// volume_fraction_cube's sum over its two 5-tet decompositions; corner
// (bi, bj, bk) at c[bi + 2 bj + 4 bk]
__device__ __forceinline__ float cube_sum(const float (&c)[8]) {
  const float p000 = c[0], p100 = c[1], p010 = c[2], p110 = c[3];
  const float p001 = c[4], p101 = c[5], p011 = c[6], p111 = c[7];
  float s = tet(p000, p001, p101, p011) + tet(p000, p101, p100, p110);
  s = s + tet(p000, p010, p011, p110);
  s = s + tet(p101, p011, p111, p110);
  s = s + 2.f * tet(p000, p011, p101, p110);
  s = s + tet(p100, p101, p001, p111);
  s = s + tet(p100, p001, p000, p010);
  s = s + tet(p100, p110, p111, p010);
  s = s + tet(p001, p111, p011, p010);
  s = s + 2.f * tet(p100, p111, p001, p010);
  return s;
}

// This thread's cells of plane p of phi (tile and halo), 0 outside phi.
__device__ __forceinline__ void fetch(const VolArgs& a, int p, int j0, int k0,
                                      float (&v)[LOADS]) {
  const bool plane = p >= 0 && p < a.I;
#pragma unroll
  for (int n = 0; n < LOADS; ++n) {
    const int idx = (int)threadIdx.x + n * NT;
    const int hj = idx / SK, hk = idx - hj * SK;
    const int gj = j0 - H + hj, gk = k0 - H + hk;
    float val = 0.f;
    if (idx < PLANE && plane && gj >= 0 && gj < a.J && gk >= 0 && gk < a.K)
      val = __ldg(a.phi + (p * a.J + gj) * a.K + gk);
    v[n] = val;
  }
}

__device__ __forceinline__ void stash(float* ph, int p,
                                      const float (&v)[LOADS]) {
  float* dst = ph + slot(p) * PLANE;
#pragma unroll
  for (int n = 0; n < LOADS; ++n) {
    const int idx = (int)threadIdx.x + n * NT;
    if (idx < PLANE) dst[idx] = v[n];
  }
}

// The 7 grids at node (i, j, k), s its cell in a shared plane.
__device__ __forceinline__ void node(const VolArgs& a, const float* ph, int i,
                                     int j, int k, int s) {
  // phi at node + (di, dj, dk), |d| <= 2 on each axis
  auto at = [&](int di, int dj, int dk) {
    return ph[slot(i + di) * PLANE + s + dj * SK + dk];
  };
  // the dilated mask over the L1 ball of radius 2; whether phi is <= 0
  // (le) or > 0 (gt) on the whole 3x3x3 block, which holds every phi a
  // corner sample of the node's cubes reads
  bool mask = false, le = true, gt = true;
#pragma unroll
  for (int di = -H; di <= H; ++di)
#pragma unroll
    for (int dj = -H; dj <= H; ++dj)
#pragma unroll
      for (int dk = -H; dk <= H; ++dk) {
        const int ai = di < 0 ? -di : di, aj = dj < 0 ? -dj : dj,
                  ak = dk < 0 ? -dk : dk;
        const bool ball = ai + aj + ak <= H;
        const bool block = ai <= 1 && aj <= 1 && ak <= 1;
        if (ball || block) {
          const float v = at(di, dj, dk);
          if (ball) mask |= v < 0.f;
          if (block) {
            le &= v <= 0.f;
            gt &= v > 0.f;
          }
        }
      }
#pragma unroll 1
  for (int g = 0; g < GRIDS; ++g) {
    const int av = a.avg[g];
    const int ai = av & 1, aj = (av >> 1) & 1, ak = (av >> 2) & 1;
    const int gJ = a.J + aj, gK = a.K + ak;
    if (i >= a.I + ai || j >= gJ || k >= gK) continue;
    // 0 off the mask; 12 ones over 12 where every corner is <= 0, which
    // the block's le implies (averages of values <= 0 are <= 0); 0 where
    // every corner is > 0, which gt implies
    float frac = 0.f;
    if (mask && le) {
      frac = 12.f * a.inv12;
    } else if (mask && !gt) {
      // the lower averaged axis (la*) and the higher (hb*) of a grid that
      // averages two
      const int la_i = ai, la_j = ai ? 0 : aj, la_k = 0;
      const int hb_i = 0, hb_j = ai ? aj : 0, hb_k = ak;
      float c[8];
      bool inside = true, outside = true;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int bi = b & 1, bj = (b >> 1) & 1, bk = b >> 2;
        float v;
        if (av == 0) {
          v = at(bi, bj, bk);
        } else if (av == 1 || av == 2 || av == 4) {
          v = 0.5f * (at(bi - ai, bj - aj, bk - ak) + at(bi, bj, bk));
        } else {
          v = 0.5f * (0.5f * (at(bi - la_i - hb_i, bj - la_j - hb_j,
                                 bk - la_k - hb_k) +
                              at(bi - hb_i, bj - hb_j, bk - hb_k)) +
                      0.5f * (at(bi - la_i, bj - la_j, bk - la_k) +
                              at(bi, bj, bk)));
        }
        c[b] = v;
        inside = inside && v <= 0.f;
        outside = outside && v > 0.f;
      }
      if (inside)
        frac = 12.f * a.inv12;
      else if (!outside)
        frac = cube_sum(c) * a.inv12;
    }
    a.out[g][(i * gJ + j) * gK + k] = frac;
  }
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    visc_volumes_kernel(const VolArgs a) {
  __shared__ float ph[RING * PLANE];
  const int NI = a.I + 1, NJ = a.J + 1, NK = a.K + 1;  // the nodes
  const int tiles_k = (NK + TK - 1) / TK, tiles_j = (NJ + TJ - 1) / TJ;
  int bx = (int)blockIdx.x;
  const int k0 = (bx % tiles_k) * TK;
  bx /= tiles_k;
  const int j0 = (bx % tiles_j) * TJ;
  bx /= tiles_j;
  const int ia = bx * a.chunk, ib = min(ia + a.chunk, NI);
  const int t = (int)threadIdx.x;
  const int j = j0 + t / TK, k = k0 + t % TK;
  const int s = (t / TK + H) * SK + t % TK + H;  // own cell in a plane

  float v[LOADS];
  for (int p = ia - H; p <= ia + H; ++p) {
    fetch(a, p, j0, k0, v);
    stash(ph, p, v);
  }
  __syncthreads();
  for (int i = ia; i < ib; ++i) {
    // plane i+3 is the +2 neighbour of the step after; its load is issued
    // before this step's work and stored after it
    const bool next = i + 1 < ib;
    if (next) fetch(a, i + H + 1, j0, k0, v);
    if (j < NJ && k < NK) node(a, ph, i, j, k, s);
    if (next) stash(ph, i + H + 1, v);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- assembly

// a grid and its shape; reads outside it give 0
struct Grid {
  const float* p;
  int I, J, K;
};

__device__ __forceinline__ float read(const Grid& g, int i, int j, int k) {
  return (i >= 0 && i < g.I && j >= 0 && j < g.J && k >= 0 && k < g.K)
             ? __ldg(g.p + (i * g.J + j) * g.K + k)
             : 0.f;
}

// one direction (r, l, t, b, f, k) of a component's rows
struct Key {
  Grid vol;       // the volume grid it reads
  int go[3];      // at this offset
  int nvisc;      // viscosity nodes averaged: 1 or 4
  int vo[4][3];   // at these offsets
  int twice;      // a doubled direction
};

struct Comp {
  const float* vel;
  const unsigned char* solid;
  const unsigned char* mask;  // the rows' range; null: [1, size) per axis
  unsigned char* in_mat;
  float* diag;
  float* vol;
  float* f[6];
  float* xd;                  // vel on solid faces, 0 elsewhere
  Grid own;                   // the component's own volume grid
  Key key[6];
  int I, J, K;
};

struct AsmArgs {
  Comp c[3];
  Grid visc;
  int size[3];                // cfg.isize, jsize, ksize
  float factor, factor2;      // dt / dx^2 and twice it, in f32
};

template <int C>
__device__ __forceinline__ void assemble(const AsmArgs& a) {
  const Comp& m = a.c[C];
  const int n = (int)blockIdx.x * NT + (int)threadIdx.x;
  if (n >= m.I * m.J * m.K) return;
  const int k = n % m.K, j = (n / m.K) % m.J, i = n / (m.J * m.K);
  const float vf = read(m.own, i, j, k);
  bool any = vf > 0.f;
  float diag = vf;
  float fac[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const Key& s = m.key[q];
    float visc;
    if (s.nvisc == 1) {
      visc = read(a.visc, i + s.vo[0][0], j + s.vo[0][1], k + s.vo[0][2]);
    } else {
      float acc = 0.f + read(a.visc, i + s.vo[0][0], j + s.vo[0][1],
                             k + s.vo[0][2]);
#pragma unroll
      for (int o = 1; o < 4; ++o)
        acc = acc + read(a.visc, i + s.vo[o][0], j + s.vo[o][1],
                         k + s.vo[o][2]);
      visc = 0.25f * acc;
    }
    const float vol = read(s.vol, i + s.go[0], j + s.go[1], k + s.go[2]);
    any = any || vol > 0.f;
    fac[q] = (s.twice ? a.factor2 : a.factor) * visc * vol;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) diag = diag + fac[q];
  const bool solid = m.solid[n] != 0;
  const bool in_range =
      m.mask ? m.mask[n] != 0
             : (i >= 1 && i < a.size[0] && j >= 1 && j < a.size[1] &&
                k >= 1 && k < a.size[2]);
  const bool rows = in_range && !solid && any;
  m.in_mat[n] = rows;
  m.diag[n] = rows ? diag : 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) m.f[q][n] = rows ? fac[q] : 0.f;
  m.vol[n] = vf;
  m.xd[n] = __ldg(m.vel + n) * (solid ? 1.f : 0.f);
}

__global__ void __launch_bounds__(NT) visc_assemble_kernel(const AsmArgs a) {
  if (blockIdx.y == 0)
    assemble<0>(a);
  else if (blockIdx.y == 1)
    assemble<1>(a);
  else
    assemble<2>(a);
}

// ------------------------------------------------------------------- rhs

struct RhsComp {
  const unsigned char* in_mat;
  const float* vol;
  const float* vel;
  const float* c;  // the coupling of the Dirichlet velocities (K13)
  float* rhs;
  int n;
};

struct RhsArgs {
  RhsComp c[3];
};

template <int C>
__device__ __forceinline__ void rhs(const RhsArgs& a) {
  const RhsComp& m = a.c[C];
  const int n = (int)blockIdx.x * NT + (int)threadIdx.x;
  if (n >= m.n) return;
  m.rhs[n] = m.in_mat[n] ? __ldg(m.vol + n) * __ldg(m.vel + n) -
                               __ldg(m.c + n)
                         : 0.f;
}

__global__ void __launch_bounds__(NT) visc_rhs_kernel(const RhsArgs a) {
  if (blockIdx.y == 0)
    rhs<0>(a);
  else if (blockIdx.y == 1)
    rhs<1>(a);
  else
    rhs<2>(a);
}

int blocks_of(int cells) { return (cells + NT - 1) / NT; }

}  // namespace

// phi: (I, J, K) = dims; out: the 7 grids; avg: each grid's averaged
// axes (VolArgs::avg); chunk: the planes a block marches through; inv12:
// 1/12 rounded to f32.
extern "C" int flip3d_visc_volumes(const float* phi, float* const* out,
                                   const int* avg, const int* dims,
                                   int chunk, float inv12, void* stream) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  VolArgs a;
  a.phi = phi;
  for (int g = 0; g < GRIDS; ++g) {
    a.out[g] = out[g];
    a.avg[g] = avg[g];
  }
  a.I = dims[0];
  a.J = dims[1];
  a.K = dims[2];
  a.chunk = chunk;
  a.inv12 = inv12;
  const int64_t blocks = (int64_t)((a.I + 1 + chunk - 1) / chunk) *
                         ((a.J + 1 + TJ - 1) / TJ) * ((a.K + 1 + TK - 1) / TK);
  visc_volumes_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Per component (u, v, w), 20 pointers: vel, solid, mask (null: the
// index range), in_mat, diag, vol, the factors r, l, t, b, f, k, xd, the
// own volume grid, the six directions' volume grids; then the viscosity
// nodes (61 in all). Per component, 126 ints: its shape, the own grid's
// shape, and per direction the volume grid's shape, its offset (3), the
// nodes averaged, their 4 offsets (12) and whether it is doubled; then the
// viscosity's shape and cfg's isize, jsize, ksize (384 in all).
extern "C" int flip3d_visc_assemble(const void* const* ptrs, const int* ints,
                                    float factor, float factor2,
                                    void* stream) {
  AsmArgs a;
  int cells = 0;
  for (int c = 0; c < 3; ++c) {
    const void* const* p = ptrs + 20 * c;
    const int* q = ints + 126 * c;
    Comp& m = a.c[c];
    m.vel = (const float*)p[0];
    m.solid = (const unsigned char*)p[1];
    m.mask = (const unsigned char*)p[2];
    m.in_mat = (unsigned char*)p[3];
    m.diag = (float*)p[4];
    m.vol = (float*)p[5];
    for (int f = 0; f < 6; ++f) m.f[f] = (float*)p[6 + f];
    m.xd = (float*)p[12];
    m.own = Grid{(const float*)p[13], q[3], q[4], q[5]};
    m.I = q[0];
    m.J = q[1];
    m.K = q[2];
    for (int d = 0; d < 6; ++d) {
      const int* r = q + 6 + 20 * d;
      Key& key = m.key[d];
      key.vol = Grid{(const float*)p[14 + d], r[0], r[1], r[2]};
      for (int x = 0; x < 3; ++x) key.go[x] = r[3 + x];
      key.nvisc = r[6];
      for (int o = 0; o < 4; ++o)
        for (int x = 0; x < 3; ++x) key.vo[o][x] = r[7 + 3 * o + x];
      key.twice = r[19];
    }
    const int n = m.I * m.J * m.K;
    cells = cells > n ? cells : n;
  }
  a.visc = Grid{(const float*)ptrs[60], ints[378], ints[379], ints[380]};
  for (int x = 0; x < 3; ++x) a.size[x] = ints[381 + x];
  a.factor = factor;
  a.factor2 = factor2;
  if (cells == 0) return 0;
  visc_assemble_kernel<<<dim3((unsigned)blocks_of(cells), 3), NT, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Per component (u, v, w), 5 pointers: in_mat, vol, vel, c, rhs; cells:
// each component's cell count.
extern "C" int flip3d_visc_rhs(const void* const* ptrs, const int* cells,
                               void* stream) {
  RhsArgs a;
  int most = 0;
  for (int c = 0; c < 3; ++c) {
    const void* const* p = ptrs + 5 * c;
    a.c[c] = RhsComp{(const unsigned char*)p[0], (const float*)p[1],
                     (const float*)p[2], (const float*)p[3], (float*)p[4],
                     cells[c]};
    most = most > cells[c] ? most : cells[c];
  }
  if (most == 0) return 0;
  visc_rhs_kernel<<<dim3((unsigned)blocks_of(most), 3), NT, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
