// V-cycle level kernels K3 mg_down and K4 mg_up.
//
// Replaces flipviscosity3d_tpu/ops/pallas_mg.py::down (_down_kernel) and
// ::up (_up_kernel). One level of the V(1,1) cycle of both CG solves is one
// DOWN and one UP launch:
//   DOWN: x = omega*D^-1 b;  r = b - A x;  rc = 2x2x2 sum-pool of r
//   UP:   x2 = x + scale*xc[parent];  out = x2 + omega*D^-1 (b - A x2)
// with A x = diag*x - sum_ax (L_ax*x(+ax) + L_ax(-ax)*x(-ax)), zero out of
// range, on the level's real (nb, I, J, K) shape.
//
// What bounds it on the H100: memory traffic. Per fine cell DOWN reads the
// operator (4 values: 8 bytes in bf16, 16 in f32) and b and writes x and an
// eighth of rc, 16.5 bytes with a bf16 operator; UP reads the operator, b, x
// and an eighth of xc and writes its output, 20.5 bytes. Both do ~20 flops
// per cell, far below the card's balance point, so the design's job is to
// read each input byte from device memory once, in coalesced rows, with
// enough loads in flight to cover the latency. (The TPU kernel blocked BI
// i-rows in VMEM with halo row blocks for the same reason.)
//
// The design. A block of 256 threads owns a 16 (k) x 16 (j) tile of fine
// columns of one batch entry and marches along i through a chunk of planes,
// two planes (an i-pair) a step (march() below). A warp holds two j rows of
// 16 k; each thread one column. The wrapper (ops/pallas_mg.py::plane_chunk)
// makes the chunk an even count of planes and sizes it to give about eight
// waves of blocks, so that the last, partly filled wave costs little.
// - Each thread keeps its own column in registers: the inputs of planes i,
//   i+1, i+2, and x (DOWN) or x2 (UP) of i-1 and l0 of i-1, so the +-i
//   terms need no neighbour's load.
// - The loads of planes i+3 and i+4 (operator, b; x and xc for UP) and of
//   the halo's i+2 and i+3 are issued at the top of the step, so each load
//   has a whole step of arithmetic to arrive in and two planes of loads are
//   in flight. The -j and -k links come from L1 when used (the tile's own
//   loads brought them in), which keeps a thread within the 64 registers
//   that four blocks an SM allow.
// - x (x2) of the pair's two planes, for the tile and a one-cell j/k halo
//   (computed by 64 threads from the halo cells' own inputs; 0 out of
//   range), goes to shared memory, in one of two pairs of buffers, so one
//   __syncthreads a step suffices; the +-j, +-k neighbours come from there.
// - UP loads each coarse xc once per i-pair and reuses it on the odd
//   plane; the four fine columns of a warp that share a parent read one
//   address.
// - DOWN pools without atomics or a second pass: the i-pair sum is formed
//   in registers, the j-pair by a warp shuffle between the warp's two rows,
//   the k-pair by a shuffle between neighbouring lanes.
// - Offsets are 32-bit (a level has fewer than 2^31 cells).
// TMA is not used: the levels' rows (129, 65, 33, 17, 9 values) are not
// multiples of 16 bytes, which a tensor map needs.
//
// Rounding: the library is built with -fmad=false and every expression
// keeps the plain PyTorch version's order (ops/pallas_mg.py): x =
// (omega*inv(d))*b; y = d*x, then the six link terms subtracted in the order
// +i, -i, +j, -j, +k, -k, each product rounded first; r = b - y; the pool
// sums i-pairs, then j-pairs, then k-pairs (each pair sum is commutative,
// so which lane adds it does not matter); UP's out = x2 + (omega*inv(d))*r.
// So both kernels are bit-equal to their plain versions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TK = 16;                       // fine k columns of a tile
constexpr int TJ = 16;                       // fine j rows of a tile
constexpr int NT = TK * TJ;                  // threads of a block
constexpr int HS = 48;                       // shared row stride: = 16 mod 32,
                                             // so a warp's two rows use
                                             // disjoint banks
constexpr int HR = TJ + 2;                   // shared rows: tile + j halo
constexpr int NHALO = 2 * TK + 2 * TJ;       // halo cells of a plane
constexpr unsigned FULL = 0xffffffffu;
// blocks an SM holds at once (ops/pallas_mg.py::_BLOCKS_PER_SM): 64
// registers a thread
constexpr int BLOCKS_PER_SM = 4;

template <typename T>
__device__ __forceinline__ float ld(const T* p, int i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, int i) {
  return __ldg(p + i);
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                   int i) {
  return __bfloat162float(__ldg(p + i));
}

// 1/d where d > 0, else 0, as the plain version's where(d > 0, 1 / where(d
// == 0, 1, d), 0): the divisor is 1 where d is not positive, so that no
// lane divides by 0 (which leaves the division's fast path).
__device__ __forceinline__ float inv_diag(float d) {
  const bool pos = d > 0.f;
  const float q = 1.0f / (pos ? d : 1.0f);
  return pos ? q : 0.f;
}

// Where a thread works: its own fine column of the block's tile and, for
// the first NHALO threads, one halo cell of the tile's planes (the row
// below and above the tile, the column left and right of it). Offsets are
// in elements and fit in 32 bits (the wrapper checks the level's size).
struct Where {
  int I, J, K;
  int P;            // plane stride J*K
  int Pc;           // coarse plane stride
  int col;          // offset of the own column's cell in plane 0
  int hcol;         // offset of the halo cell in plane 0
  int pcol;         // offset of the own column's parent in coarse plane 0
  int hpcol;        // offset of the halo cell's parent in coarse plane 0
  int j, k;         // own fine column
  int ia, ib;       // the block's planes [ia, ib)
  int slot, hslot;  // shared slots of the own and the halo cell
  bool act;         // the own column lies in the level
  bool has_h;       // this thread owns a halo cell
  bool hact;        // ... and it lies in the level
};

__device__ __forceinline__ Where where(int I, int J, int K, int chunk) {
  Where w;
  w.I = I;
  w.J = J;
  w.K = K;
  const int tiles_k = (K + TK - 1) / TK, tiles_j = (J + TJ - 1) / TJ;
  const int n_chunks = (I + chunk - 1) / chunk;
  int bx = (int)blockIdx.x;
  const int tk = bx % tiles_k;
  bx /= tiles_k;
  const int tj = bx % tiles_j;
  bx /= tiles_j;
  const int ch = bx % n_chunks;
  const int bb = bx / n_chunks;
  const int t = threadIdx.x;
  const int jj = ((t >> 5) << 1) | ((t >> 4) & 1), kk = t & 15;
  const int j0 = tj * TJ, k0 = tk * TK;
  w.j = j0 + jj;
  w.k = k0 + kk;
  w.act = w.j < J && w.k < K;
  w.P = J * K;
  const int base = bb * I * w.P;
  w.col = base + w.j * K + w.k;
  w.slot = (jj + 1) * HS + kk + 1;

  int hj, hk;
  if (t < TK) {
    hj = -1;
    hk = t;
  } else if (t < 2 * TK) {
    hj = TJ;
    hk = t - TK;
  } else if (t < 2 * TK + TJ) {
    hj = t - 2 * TK;
    hk = -1;
  } else {
    hj = t - 2 * TK - TJ;
    hk = TK;
  }
  w.has_h = t < NHALO;
  const int gj = j0 + hj, gk = k0 + hk;
  w.hact = w.has_h && gj >= 0 && gj < J && gk >= 0 && gk < K;
  w.hcol = base + gj * K + gk;
  w.hslot = w.has_h ? (hj + 1) * HS + hk + 1 : 0;

  const int Ic = (I + 1) >> 1, Jc = (J + 1) >> 1, Kc = (K + 1) >> 1;
  w.Pc = Jc * Kc;
  const int cbase = bb * Ic * w.Pc;
  w.pcol = cbase + (w.j >> 1) * Kc + (w.k >> 1);
  w.hpcol = cbase + (gj >> 1) * Kc + (gk >> 1);

  w.ia = ch * chunk;
  w.ib = min(w.ia + chunk, I);
  return w;
}

// The own column's inputs of one plane.
struct Cell {
  float d, b, l0, l1, l2;
  float x, xc;     // UP only: x and the parent's xc
};

// Plane p's operator and b of the own column.
template <typename T>
__device__ __forceinline__ void load_operator(Cell& v, const T* d,
                                              const T* l0, const T* l1,
                                              const T* l2, const float* b,
                                              const Where& w, int p) {
  const int c = w.col + p * w.P;
  v.d = ld(d, c);
  v.b = __ldg(b + c);
  v.l0 = ld(l0, c);
  v.l1 = ld(l1, c);
  v.l2 = ld(l2, c);
}

// y = d*x - the six link terms (+i, -i, +j, -j, +k, -k; each product
// rounded before its subtraction), r = b - y, at plane i of the own column:
// x of plane i, of i-1 (with l0 of i-1) and of i+1 from registers, the
// j / k neighbours' x from the shared plane s, their links l1 one row below
// and l2 one column left from L1 (the tile's own loads of the plane
// brought them in; loading them with the plane would hold two more
// registers a plane).
template <typename T>
__device__ __forceinline__ float residual(const Cell& v, const Where& w,
                                          int i, float x, float x_m,
                                          float l0_m, float x_p,
                                          const float* s, const T* l1,
                                          const T* l2) {
  const int c = w.col + i * w.P;
  float y = v.d * x;
  if (i + 1 < w.I) y = y - v.l0 * x_p;
  if (i > 0) y = y - l0_m * x_m;
  if (w.j + 1 < w.J) y = y - v.l1 * s[w.slot + HS];
  if (w.j > 0) y = y - ld(l1, c - w.K) * s[w.slot - HS];
  if (w.k + 1 < w.K) y = y - v.l2 * s[w.slot + 1];
  if (w.k > 0) y = y - ld(l2, c - 1) * s[w.slot - 1];
  return v.b - y;
}

// The march, shared by both kernels, two planes (an i-pair) per step. At
// the step of planes i, i+1 the own column's inputs of i, i+1 and i+2 are
// in registers and the loads of i+3 and i+4 (and of the halo's i+2, i+3)
// are issued before anything of plane i is computed; plane i+2's x is
// needed for plane i+1's +i term. The shared planes of a step are written
// to one of two pairs of buffers, so one __syncthreads a step suffices.
//   K::load(p, prev)  own inputs of plane p (prev: plane p-1's)
//   K::halo(p, prev)  the halo cell's inputs of plane p
//   K::x(v)           x (DOWN) or x2 (UP) of a cell's inputs
//   K::emit(...)      what a plane writes; returns r for DOWN's pool
//   K::pool(i, r0, r1) after the pair (DOWN: the restriction)
template <typename K_>
__device__ __forceinline__ void march(K_& kern, const Where& w,
                                      float (*xs)[HR * HS]) {
  typedef typename K_::Halo H;
  float x_m = 0.f, l0_m = 0.f;  // x and l0 one plane below the pair
  if (w.act && w.ia > 0) kern.below(w.ia - 1, x_m, l0_m);
  Cell A = kern.load(w.ia, Cell{});
  Cell B = kern.load(w.ia + 1, A);
  Cell C = kern.load(w.ia + 2, B);
  H h0 = kern.halo(w.ia, H{}), h1 = kern.halo(w.ia + 1, h0);
  float x0 = kern.x(A);
  int buf = 0;
  for (int i = w.ia; i < w.ib; i += 2) {
    const Cell D = kern.load(i + 3, C);
    const Cell E = kern.load(i + 4, D);
    const H h2 = kern.halo(i + 2, h1), h3 = kern.halo(i + 3, h2);
    const float x1 = kern.x(B), x2 = kern.x(C);
    float* s0 = xs[buf];
    float* s1 = xs[buf + 1];
    s0[w.slot] = x0;
    s1[w.slot] = x1;
    if (w.has_h) {
      s0[w.hslot] = kern.hx(h0);
      s1[w.hslot] = kern.hx(h1);
    }
    __syncthreads();
    float r0 = 0.f, r1 = 0.f;
    const bool odd = i + 1 < w.I;  // the pair has its odd plane
    if (w.act) {
      r0 = kern.emit(A, i, x0,
                     residual(A, w, i, x0, x_m, l0_m, x1, s0, kern.l1,
                              kern.l2));
      if (odd)
        r1 = kern.emit(B, i + 1, x1,
                       residual(B, w, i + 1, x1, x0, A.l0, x2, s1, kern.l1,
                                kern.l2));
    }
    kern.pool(i, odd, r0, r1);
    x_m = x1;
    l0_m = B.l0;
    x0 = x2;
    A = C;
    B = D;
    C = E;
    h0 = h2;
    h1 = h3;
    buf ^= 2;
  }
}

template <typename T>
struct Down {
  struct Halo {
    float d, b;
  };
  const T *d, *l0, *l1, *l2;
  const float* b;
  float omega;
  float* x_out;
  float* rc_out;
  const Where& w;
  bool writes_rc;

  __device__ __forceinline__ float x(const Cell& v) const {
    return (omega * inv_diag(v.d)) * v.b;
  }
  __device__ __forceinline__ float hx(const Halo& h) const {
    return (omega * inv_diag(h.d)) * h.b;
  }
  // plane p: the operator and b for the block's planes, d and b alone for
  // the plane above them, zeros past it
  __device__ __forceinline__ Cell load(int p, const Cell&) const {
    Cell v{};
    if (w.act && p <= w.ib && p < w.I) {
      if (p < w.ib) {
        load_operator(v, d, l0, l1, l2, b, w, p);
      } else {
        const int c = w.col + p * w.P;
        v.d = ld(d, c);
        v.b = __ldg(b + c);
      }
    }
    return v;
  }
  __device__ __forceinline__ Halo halo(int p, const Halo&) const {
    Halo h{};
    if (w.hact && p < w.ib) {
      const int c = w.hcol + p * w.P;
      h.d = ld(d, c);
      h.b = __ldg(b + c);
    }
    return h;
  }
  __device__ __forceinline__ void below(int p, float& x_m,
                                        float& l0_m) const {
    const int c = w.col + p * w.P;
    Cell v{};
    v.d = ld(d, c);
    v.b = __ldg(b + c);
    x_m = x(v);
    l0_m = ld(l0, c);
  }
  __device__ __forceinline__ float emit(const Cell&, int i, float xv,
                                        float r) const {
    x_out[w.col + i * w.P] = xv;
    return r;
  }
  // the i-pair sum in registers, then the j-pair (the warp's other row),
  // then the k-pair (the neighbouring lane); an odd I's last plane pools
  // with zeros, and so do columns past J or K (their r is 0)
  __device__ __forceinline__ void pool(int i, bool odd, float r0,
                                       float r1) const {
    float s = odd ? r0 + r1 : r0 + 0.f;
    s = s + __shfl_xor_sync(FULL, s, 16);
    s = s + __shfl_xor_sync(FULL, s, 1);
    if (writes_rc) rc_out[w.pcol + (i >> 1) * w.Pc] = s;
  }
};

template <typename T>
struct Up {
  struct Halo {
    float x, xc;
  };
  const T *d, *l0, *l1, *l2;
  const float *b, *xv, *xcv;
  float omega, scale;
  float* out;
  const Where& w;

  __device__ __forceinline__ float x(const Cell& v) const {
    return v.x + scale * v.xc;
  }
  __device__ __forceinline__ float hx(const Halo& h) const {
    return h.x + scale * h.xc;
  }
  // plane p: x and the parent's xc (an odd plane shares plane p-1's parent)
  // for the block's planes and the one above them, the operator and b for
  // the block's planes; zeros past them
  __device__ __forceinline__ Cell load(int p, const Cell& prev) const {
    Cell v{};
    if (w.act && p <= w.ib && p < w.I) {
      v.x = __ldg(xv + w.col + p * w.P);
      v.xc = (p & 1) ? prev.xc : __ldg(xcv + w.pcol + (p >> 1) * w.Pc);
      if (p < w.ib) load_operator(v, d, l0, l1, l2, b, w, p);
    }
    return v;
  }
  __device__ __forceinline__ Halo halo(int p, const Halo& prev) const {
    Halo h{};
    if (w.hact && p < w.ib) {
      h.x = __ldg(xv + w.hcol + p * w.P);
      h.xc = (p & 1) ? prev.xc : __ldg(xcv + w.hpcol + (p >> 1) * w.Pc);
    }
    return h;
  }
  __device__ __forceinline__ void below(int p, float& x_m,
                                        float& l0_m) const {
    const int c = w.col + p * w.P;
    x_m = __ldg(xv + c) + scale * __ldg(xcv + w.pcol + (p >> 1) * w.Pc);
    l0_m = ld(l0, c);
  }
  __device__ __forceinline__ float emit(const Cell& v, int i, float x2,
                                        float r) const {
    out[w.col + i * w.P] = x2 + (omega * inv_diag(v.d)) * r;
    return 0.f;
  }
  __device__ __forceinline__ void pool(int, bool, float, float) const {}
};

template <typename T>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    mg_down_kernel(const T* __restrict__ d, const T* __restrict__ l0,
                   const T* __restrict__ l1, const T* __restrict__ l2,
                   const float* __restrict__ b, int I, int J, int K,
                   int chunk, float omega, float* __restrict__ x_out,
                   float* __restrict__ rc_out) {
  __shared__ float xs[4][HR * HS];
  const Where w = where(I, J, K, chunk);
  Down<T> kern{d, l0, l1, l2, b, omega, x_out, rc_out, w,
               w.act && !(w.j & 1) && !(w.k & 1)};
  march(kern, w, xs);
}

template <typename T>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    mg_up_kernel(const T* __restrict__ d, const T* __restrict__ l0,
                 const T* __restrict__ l1, const T* __restrict__ l2,
                 const float* __restrict__ b, const float* __restrict__ x,
                 const float* __restrict__ xc, int I, int J, int K,
                 int chunk, float omega, float scale,
                 float* __restrict__ out) {
  __shared__ float xs[4][HR * HS];
  const Where w = where(I, J, K, chunk);
  Up<T> kern{d, l0, l1, l2, b, x, xc, omega, scale, out, w};
  march(kern, w, xs);
}

inline unsigned blocks_for(int nb, int I, int J, int K, int chunk) {
  return (unsigned)((int64_t)nb * ((I + chunk - 1) / chunk) *
                    ((J + TJ - 1) / TJ) * ((K + TK - 1) / TK));
}

template <typename T>
int launch_down(const void* d, const void* l0, const void* l1, const void* l2,
                const float* b, int nb, int I, int J, int K, int chunk,
                float omega, float* x, float* rc, void* stream) {
  if (chunk < 2 || (chunk & 1)) return (int)cudaErrorInvalidValue;
  mg_down_kernel<T><<<blocks_for(nb, I, J, K, chunk), NT, 0,
                      (cudaStream_t)stream>>>(
      (const T*)d, (const T*)l0, (const T*)l1, (const T*)l2, b, I, J, K,
      chunk, omega, x, rc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_up(const void* d, const void* l0, const void* l1, const void* l2,
              const float* b, const float* x, const float* xc, int nb, int I,
              int J, int K, int chunk, float omega, float scale, float* out,
              void* stream) {
  if (chunk < 2 || (chunk & 1)) return (int)cudaErrorInvalidValue;
  mg_up_kernel<T><<<blocks_for(nb, I, J, K, chunk), NT, 0,
                    (cudaStream_t)stream>>>(
      (const T*)d, (const T*)l0, (const T*)l1, (const T*)l2, b, x, xc, I, J,
      K, chunk, omega, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flip3d_mg_down_f32(const void* d, const void* l0, const void* l1,
                       const void* l2, const float* b, int nb, int I, int J,
                       int K, int chunk, float omega, float* x, float* rc,
                       void* stream) {
  return launch_down<float>(d, l0, l1, l2, b, nb, I, J, K, chunk, omega, x,
                            rc, stream);
}

int flip3d_mg_down_bf16(const void* d, const void* l0, const void* l1,
                        const void* l2, const float* b, int nb, int I, int J,
                        int K, int chunk, float omega, float* x, float* rc,
                        void* stream) {
  return launch_down<__nv_bfloat16>(d, l0, l1, l2, b, nb, I, J, K, chunk,
                                    omega, x, rc, stream);
}

int flip3d_mg_up_f32(const void* d, const void* l0, const void* l1,
                     const void* l2, const float* b, const float* x,
                     const float* xc, int nb, int I, int J, int K, int chunk,
                     float omega, float scale, float* out, void* stream) {
  return launch_up<float>(d, l0, l1, l2, b, x, xc, nb, I, J, K, chunk, omega,
                          scale, out, stream);
}

int flip3d_mg_up_bf16(const void* d, const void* l0, const void* l1,
                      const void* l2, const float* b, const float* x,
                      const float* xc, int nb, int I, int J, int K, int chunk,
                      float omega, float scale, float* out, void* stream) {
  return launch_up<__nv_bfloat16>(d, l0, l1, l2, b, x, xc, nb, I, J, K,
                                  chunk, omega, scale, out, stream);
}

}  // extern "C"
