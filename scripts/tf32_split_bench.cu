// What the float32 flash attention kernels' split-TF32 arithmetic costs
// and how the tensor core reads a tf32 operand, on the card alone.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_split_bench \
//       scripts/tf32_split_bench.cu && ./tf32_split_bench [DUMP]
//
// (DUMP: a file for part 3's operands and results, float32 a, b, c, d.)
//
// 1. mma.sync m16n8k8 tf32 throughput, 2 CTAs an SM of 4, 8 or 16 warps,
//    each warp issuing from registers: one product a step (8 independent
//    accumulators), three products of operands split once before the
//    loop, and three products with every operand split in the loop by
//    cvt.rna.tf32.f32, by a bit mask (round half up on the magnitude) or
//    by Veltkamp's split (three float32 operations,
//    src/repro_torch/csrc/tf32.cuh).  TFLOP/s count 2 x 16 x 8 x 8 a
//    product.
// 2. The read of an operand that is not tf32: 8 products a x 1.0 with a
//    just past tf32's 10 mantissa bits, printed beside the sums a
//    truncated, a rounded and a full read would give.
// 3. The accumulator's addition: one mma.sync on tf32 operands of random
//    sign and exponent and a float32 accumulator, each of the 128 results
//    of a warp held against models of how the tensor core adds its 8
//    exact products to the accumulator: the share of results each model
//    gives bit for bit, and each model's and the card's mean lean,
//    (|result| - |exact|) / |exact| (below 0: toward zero).
//    tests/test_torch_flash_split_tf32.py copies the exact sum cut toward
//    zero.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cuda_runtime.h>
#include <vector>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum Split { kCvt, kBits, kVeltkamp };

template <Split S>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (S == kCvt) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float r = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
  } else if (S == kBits) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const float r = x - __uint_as_float(hi);
    lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
  } else {
    const float c = __fmul_rn(x, 8193.f);
    const float h = __fsub_rn(c, __fsub_rn(c, x));
    hi = __float_as_uint(h);
    lo = __float_as_uint(__fsub_rn(x, h));
  }
}

// mode 0: one product, 8 accumulators; 1: three products, split before
// the loop; 2, 3, 4: three products, split in the loop (cvt, bits,
// Veltkamp)
template <int kMode>
__global__ void bench(float* out, int iters, float seed) {
  float c[8][4] = {};
  float x[6];
  for (int i = 0; i < 6; ++i) x[i] = seed * (threadIdx.x + i);
  uint32_t ah[4], al[4], bh[2], bl[2];
  for (int i = 0; i < 4; ++i) split<kBits>(x[i], ah[i], al[i]);
  for (int i = 0; i < 2; ++i) split<kBits>(x[4 + i], bh[i], bl[i]);
  for (int it = 0; it < iters; ++it) {
    if (kMode == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(c[n], ah, bh);
      continue;
    }
    constexpr Split kS = kMode == 2 ? kCvt : kMode == 3 ? kBits : kVeltkamp;
    if (kMode >= 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split<kS>(x[i] + it, ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t h[2] = {bh[0] + n, bh[1]}, l[2] = {bl[0], bl[1]};
      if (kMode >= 2) {
#pragma unroll
        for (int i = 0; i < 2; ++i) split<kS>(x[4 + i] + n + it, h[i], l[i]);
      }
      mma(c[n], al, h);
      mma(c[n], ah, l);
      mma(c[n], ah, h);
    }
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += c[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void read_of(float a_val, float* out) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(a_val);
  b[0] = b[1] = __float_as_uint(1.0f);
  mma(c, a, b);
  if (threadIdx.x == 0) out[0] = c[0];
}

// one m16n8k8 product a warp: A (16 x 8) row-major, B (8 x 8) with
// element (k, n) at b[k * 8 + n], C and D (16 x 8) row-major
__global__ void add_of(const float* a, const float* b, const float* c,
                       float* d) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a += w * 128; b += w * 64; c += w * 128; d += w * 128;
  uint32_t fa[4], fb[2];
  fa[0] = __float_as_uint(a[g * 8 + t]);
  fa[1] = __float_as_uint(a[(g + 8) * 8 + t]);
  fa[2] = __float_as_uint(a[g * 8 + t + 4]);
  fa[3] = __float_as_uint(a[(g + 8) * 8 + t + 4]);
  fb[0] = __float_as_uint(b[t * 8 + g]);
  fb[1] = __float_as_uint(b[(t + 4) * 8 + g]);
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1],
                  c[(g + 8) * 8 + 2 * t], c[(g + 8) * 8 + 2 * t + 1]};
  mma(acc, fa, fb);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint32_t next_u32() {
  rng_state = rng_state * 6364136223846793005ull + 1442695040888963407ull;
  return (uint32_t)(rng_state >> 32);
}

// a random value with `bits` significant bits, random sign, exponent in
// [-spread, spread]
static float draw(int bits, int spread) {
  const uint32_t m = (next_u32() >> (32 - 23)) & (0x7fffffu << (23 - bits + 1));
  const int e = (int)(next_u32() % (2 * spread + 1)) - spread;
  uint32_t u = ((uint32_t)(127 + e) << 23) | (m & 0x7fffffu);
  if (next_u32() & 1) u |= 0x80000000u;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// float32 of an exact double, toward zero or to nearest
static float to_f32(double x, bool toward_zero) {
  float f = (float)x;   // to nearest
  if (toward_zero && std::fabs((double)f) > std::fabs(x))
    f = std::nextafter(f, 0.f);
  return f;
}

// The sum of the accumulator and 8 products as a model adds them: each
// term cut toward zero to p bits below the largest term's leading bit
// (p = 0: no cut, the exact sum), over `split` groups of 8 / split
// products added one group after another, then the float32 of that sum
// toward zero or to nearest.
static float model(const double* prod, double c, int p, int split,
                   bool toward_zero) {
  const int per = 8 / split;
  for (int s = 0; s < split; ++s) {
    double terms[9];
    int n = 0;
    terms[n++] = c;
    for (int i = 0; i < per; ++i) terms[n++] = prod[s * per + i];
    double big = 0;
    for (int i = 0; i < n; ++i) big = std::fmax(big, std::fabs(terms[i]));
    double sum = 0;
    if (p > 0 && big > 0) {
      int e;
      std::frexp(big, &e);   // big < 2^e
      const double ulp = std::ldexp(1.0, e - p);
      for (int i = 0; i < n; ++i) sum += std::trunc(terms[i] / ulp) * ulp;
    } else {
      for (int i = 0; i < n; ++i) sum += terms[i];
    }
    c = (double)to_f32(sum, toward_zero);
  }
  return (float)c;
}

static void accumulator_models(const char* dump) {
  const int warps = 4096, spread = 6;
  std::vector<float> a(warps * 128), b(warps * 64), c(warps * 128),
      d(warps * 128);
  for (auto& x : a) x = draw(11, spread);
  for (auto& x : b) x = draw(11, spread);
  for (auto& x : c) x = draw(24, spread);
  float *da, *db, *dc, *dd;
  cudaMalloc(&da, a.size() * 4);
  cudaMalloc(&db, b.size() * 4);
  cudaMalloc(&dc, c.size() * 4);
  cudaMalloc(&dd, d.size() * 4);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dc, c.data(), c.size() * 4, cudaMemcpyHostToDevice);
  add_of<<<warps / 4, 128>>>(da, db, dc, dd);
  cudaMemcpy(d.data(), dd, d.size() * 4, cudaMemcpyDeviceToHost);
  if (dump != nullptr) {   // a, b, c, d as float32, in that order
    FILE* f = fopen(dump, "wb");
    for (const auto* v : {&a, &b, &c, &d}) fwrite(v->data(), 4, v->size(), f);
    fclose(f);
  }
  cudaFree(da);
  cudaFree(db);
  cudaFree(dc);
  cudaFree(dd);
  struct M { int p, split; bool rz; };
  std::vector<M> models;
  for (bool rz : {true, false}) {
    models.push_back({0, 1, rz});
    for (int split : {1, 2})
      for (int p = 23; p <= 28; ++p) models.push_back({p, split, rz});
  }
  // each model's and the card's mean (|result| - |exact|) / |exact|:
  // below 0, results lean toward zero
  double card_bias = 0;
  for (const M& m : models) {
    long same = 0, total = 0;
    double bias = 0;
    for (int w = 0; w < warps; ++w)
      for (int r = 0; r < 16; ++r)
        for (int n = 0; n < 8; ++n) {
          double prod[8];
          double exact = c[w * 128 + r * 8 + n];
          for (int k = 0; k < 8; ++k) {
            prod[k] = (double)a[w * 128 + r * 8 + k] * b[w * 64 + k * 8 + n];
            exact += prod[k];
          }
          const float want = model(prod, c[w * 128 + r * 8 + n], m.p,
                                   m.split, m.rz);
          const float got = d[w * 128 + r * 8 + n];
          same += memcmp(&want, &got, 4) == 0;
          ++total;
          if (exact != 0) {
            bias += (std::fabs((double)want) - std::fabs(exact)) /
                    std::fabs(exact);
            if (&m == &models[0])
              card_bias += (std::fabs((double)got) - std::fabs(exact)) /
                           std::fabs(exact);
          }
        }
    printf("[add] terms cut at %2d bits (0: none), %s, %s: %.4f of %ld "
           "results bit for bit, mean lean %.3g\n", m.p,
           m.split == 1 ? "8 products at once" : "2 groups of 4",
           m.rz ? "toward zero" : "to nearest", (double)same / total,
           total, bias / total);
  }
  printf("[add] the card's mean lean %.3g\n", card_bias / (warps * 128.0));
}

template <int kMode>
void run(const char* name, int warps, int sms) {
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 2 * warps * 32);
  const int iters = 20000;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  bench<kMode><<<sms * 2, warps * 32>>>(out, 10, 1.f);
  cudaEventRecord(a);
  bench<kMode><<<sms * 2, warps * 32>>>(out, iters, 1.f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double products = 2.0 * sms * warps * iters * (kMode == 0 ? 8 : 12);
  printf("[mma] %-28s %2d warps a CTA: %.3f ms, %.1f TFLOP/s\n", name, warps,
         ms, products * 2 * 16 * 8 * 8 / (ms * 1e9));
  cudaFree(out);
}

static float bits_to(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

int main(int argc, char** argv) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("[device] %s, %d SMs\n", prop.name, sms);
  for (int w : {4, 8, 16}) {
    run<0>("one product, 8 accumulators", w, sms);
    run<1>("3xTF32, split before", w, sms);
    run<2>("3xTF32, cvt.rna split", w, sms);
    run<3>("3xTF32, bit-mask split", w, sms);
    run<4>("3xTF32, Veltkamp split", w, sms);
  }
  float* d;
  cudaMalloc(&d, sizeof(float));
  const float vals[] = {1.0f + 0x1p-12f, 1.0f + 0x1p-11f + 0x1p-12f,
                        -(1.0f + 0x1p-11f + 0x1p-12f)};
  for (float v : vals) {
    read_of<<<1, 32>>>(v, d);
    float h;
    cudaMemcpy(&h, d, sizeof(float), cudaMemcpyDeviceToHost);
    uint32_t u;
    memcpy(&u, &v, 4);
    printf("[read] a = %.9g: 8 a = %.9g (truncated %.9g, rounded %.9g, "
           "full %.9g)\n", v, h, 8 * bits_to(u & 0xffffe000u),
           8 * bits_to((u + 0x1000u) & 0xffffe000u), 8.0 * v);
  }
  accumulator_models(argc > 1 ? argv[1] : nullptr);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
