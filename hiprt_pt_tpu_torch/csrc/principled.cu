// The layered principled BSDF for Hopper (sm_90a): eval + pdf and sample
// of models/principled.py for a batch of hits, one launch each.
//
// It replaces no Pallas kernel: the JAX package's BSDF is plain jnp that
// XLA fuses into a few loops (hiprt_pt_tpu/models/principled.py). Eager
// PyTorch cannot fuse it; its plain version (models/principled.py:
// _eval_pdf_plain, _sample_plain) runs some 4,300 elementwise kernels an
// eval and 5,200 a sample, each reading and writing (N,) or (N, 3)
// temporaries in device memory.
//
// What bounds it on this card: operations, barely. A lane reads its 45
// material floats (27 scalars, 6 colours), n, wo and wi or its RNG state,
// and the relative IOR, about 224 bytes, and writes f and pdf (16 bytes;
// sample: the state, wi, f, pdf, the refracted flag, 37 bytes). Its
// arithmetic is some 1,500 to 2,500 f32 operations (every lobe, the
// polynomial fits of the energy compensation, thin film, a dozen
// transcendentals), so at 2,073,600 lanes the two bounds are close: about
// 0.15 ms of traffic at 3.35 TB/s against 0.05 to 0.08 ms at 67 TFLOP/s.
//
// What the design does about that. One thread a lane, grid-stride over a
// resident wave, so any N works. Every material field is a structure-of-
// arrays stream, read once, coalesced; the ONB, the local frame and every
// lobe stay in registers, and nothing but the outputs goes back to device
// memory. The polynomial coefficients (the glass, glossy-base and coat
// fits, the conductor fit, the sheen LTC's Chebyshev fit) and the glass
// table's IOR grid are staged in shared memory once a block: the glass fit
// is indexed by a per-lane table selector, which a constant-memory read
// would serialise. The baked tables of glass_compensation_exact are read
// through the read-only path. The sample kernel computes only the drawn
// lobe's direction (the plain version computes all and keeps one).
//
// The plain version's numbers, as near as f32 allows: its operations in its
// order (built with -fmad=false, so no multiply and add fuse; the pieces
// PyTorch computes inside one kernel, a dot product's sum, a norm, a cross
// product, follow what PyTorch's kernels do on this card), IEEE division
// and square root, the library's powf, expf, logf, sinf and cosf, Python's
// double constants rounded to f32 as PyTorch rounds them, a tensor divided
// by a Python number multiplied by the reciprocal rounded to f32 as
// PyTorch's CUDA division does, NaN kept by clamp, minimum and maximum as torch keeps it.
// The PCG draws are core/rng.py's, in uint32, in its order: u_sel, u1, u2,
// u3.
// Options reach the kernels as run-time flags (kThinFilm ...).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// the material fields a lane reads, in ops/cuda_bsdf.py's order
// (SCALAR_FIELDS, COLOR_FIELDS); the names are the MaterialBank's
namespace sf {
enum Scalar {
  roughness, oren_nayar_sigma, metallic, metallic_F90_falloff_exponent,
  anisotropy, anisotropy_rotation, second_roughness_weight, second_roughness,
  specular, specular_tint, coat, coat_medium_thickness, coat_roughness,
  coat_darkening, coat_anisotropy, coat_ior, sheen, sheen_roughness, ior,
  specular_transmission, thin_walled, thin_film, thin_film_ior,
  thin_film_thickness, thin_film_hue_shift_degrees,
  thin_film_base_ior_override, thin_film_do_ior_override, kCount
};
}  // namespace sf
namespace cf {
enum Color {
  base_color, metallic_F82, metallic_F90, specular_color,
  coat_medium_absorption, sheen_color, kCount
};
}  // namespace cf

// the field pointers, passed by value as a kernel parameter
struct Fields {
  const float* s[sf::kCount];
  const float* c[cf::kCount];
};

// options (ops/cuda_bsdf.py:option_flags)
constexpr int kThinFilm = 1;
constexpr int kEnergyCompensation = 2;
constexpr int kCompensationExact = 4;
constexpr int kSphericalCaps = 8;

// the coefficient table (ops/cuda_bsdf.py:coefficient_table), in f32:
// the glass fits (4 tables x 75 terms over roughness^a cos^b ior'^g,
// a, b < 5, g < 3), the conductor fit (49 terms, roughness^a cos^b,
// a, b < 7), the sheen LTC fit (3 channels x 8 x 8 Chebyshev terms), the
// glass tables' IOR grid (8); then the baked conductor table (32 x 32) and
// the glass tables (4 x 8 IORs x 16 roughness x 16 cos). The first
// kStaged floats are staged in shared memory.
constexpr int kGlassDR = 5, kGlassDC = 5, kGlassDI = 3;
constexpr int kGlassTerms = kGlassDR * kGlassDC * kGlassDI;
constexpr int kCondD = 7;
constexpr int kSheenDeg = 8;
constexpr int kIors = 8;
constexpr int kCondRes = 32, kGlassRes = 16;
constexpr int kOffGlassPoly = 0;
constexpr int kOffCondPoly = kOffGlassPoly + 4 * kGlassTerms;
constexpr int kOffSheen = kOffCondPoly + kCondD * kCondD;
constexpr int kOffIors = kOffSheen + 3 * kSheenDeg * kSheenDeg;
constexpr int kStaged = kOffIors + kIors;
constexpr int kOffCondEss = kStaged;
constexpr int kOffGlassEss = kOffCondEss + kCondRes * kCondRes;
constexpr int kTableFloats = kOffGlassEss + 4 * kIors * kGlassRes * kGlassRes;

// Python's double constants as PyTorch rounds them to f32; a tensor divided
// by a Python number is multiplied by the f32 rounding of its reciprocal
#define F32(x) ((float)(x))
#define RECIP(x) F32(1.0 / (x))
#define PI_F F32(3.141592653589793)
#define TWO_PI_F F32(6.283185307179586)
#define INV_PI_F F32(0.3183098861837907)
#define ETA_MIN F32(1.001)
// fresnel.py:f82_tint: (1 - cos 82deg)^5 and cos 82deg (1 - cos 82deg)^6
#define F82_MBAR5 F32(0.47269325069829826)
#define F82_DENOM 0.056630483626257055

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}

// torch.clamp / clamp_min / maximum / minimum: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// (a * b).sum(dim=-1): three products, then the sum in the order
// PyTorch's reduction over a last dimension of 3 takes on this card (two
// threads: the first adds elements 0 and 2, the second holds 1)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return (p0 + p2) + p1;
}

// torch.linalg.norm(v, dim=-1), in the same order
__device__ __forceinline__ float norm(V3 v) {
  return sqrtf((v.x * v.x + v.z * v.z) + v.y * v.y);
}

// torch.linalg.cross(a, b): PyTorch's kernel fuses each component's first
// product into the difference
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = clamp_min(norm(v), 1e-12f);
  return {v.x / n, v.y / n, v.z / n};
}

// ops/sampling.py:build_onb (Duff et al. 2017)
__device__ __forceinline__ void build_onb(V3 n, V3& t, V3& b) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (s + n.z));
  const float bb = (n.x * n.y) * a;
  t = {1.0f + ((s * n.x) * n.x) * a, s * bb, (-s) * n.x};
  b = {bb, s + (n.y * n.y) * a, -n.y};
}

__device__ __forceinline__ V3 to_local(V3 n, V3 w) {
  V3 t, b;
  build_onb(n, t, b);
  return {dot(w, t), dot(w, b), dot(w, n)};
}

__device__ __forceinline__ V3 to_world(V3 n, V3 w) {
  V3 t, b;
  build_onb(n, t, b);
  return {(w.x * t.x + w.y * b.x) + w.z * n.x,
          (w.x * t.y + w.y * b.y) + w.z * n.y,
          (w.x * t.z + w.y * b.z) + w.z * n.z};
}

__device__ __forceinline__ float lum(const float c[3]) {
  return (F32(0.2126) * c[0] + F32(0.7152) * c[1]) + F32(0.0722) * c[2];
}

// ------------------------------------------------ fresnel.py, material.py

__device__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clampf(cos_i, 0.0f, 1.0f);
  const float sin2_t = (1.0f - cos_i * cos_i) / clamp_min(eta * eta, 1e-12f);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(clampf(1.0f - sin2_t, 0.0f, 1.0f));
  const float r_par =
      (eta * cos_i - cos_t) / clamp_min(eta * cos_i + cos_t, 1e-12f);
  const float r_perp =
      (cos_i - eta * cos_t) / clamp_min(cos_i + eta * cos_t, 1e-12f);
  const float f = 0.5f * (r_par * r_par + r_perp * r_perp);
  return tir ? 1.0f : f;
}

// Adobe F82-tint conductor Fresnel, per channel
__device__ void f82_tint(const float F0[3], const float F82[3],
                         const float F90[3], float falloff, float cos_i,
                         float out[3]) {
  const float m = clampf(1.0f - cos_i, 0.0f, 1.0f);
  const float mN = powf(m, falloff);
  const float q = (cos_i * powf(m, 6.0f)) * RECIP(F82_DENOM);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float schlick = F0[k] + (F90[k] - F0[k]) * mN;
    const float s82 = F0[k] + (F90[k] - F0[k]) * F82_MBAR5;
    const float corr = (s82 * (1.0f - F82[k])) * q;
    out[k] = clamp_min(schlick - corr, 0.0f);
  }
}

__device__ __forceinline__ void get_alphas(float r, float aniso, float& ax,
                                           float& ay) {
  const float aspect = sqrtf(1.0f - F32(0.9) * aniso);
  const float r2 = r * r;
  ax = clamp_min(r2 / aspect, F32(1e-4));
  ay = clamp_min(r2 * aspect, F32(1e-4));
}

__device__ float thin_walled_roughness(float thin_walled, float base_r,
                                       float eta) {
  eta = fabsf(eta - 1.0f) < F32(1e-3) ? ETA_MIN : eta;
  const float e5 = eta - 0.5f;
  const float remapped =
      base_r * sqrtf(clamp_min(((F32(3.7) * (eta - 1.0f)) * (e5 * e5)) /
                                   ((eta * eta) * eta),
                               0.0f));
  const float r = thin_walled > 0.5f ? remapped : base_r;
  return clampf(r, F32(1e-4), 1.0f);
}

// ------------------------------------------------------- microfacet.py

__device__ __forceinline__ V3 anisotropy_rotate(V3 w, float rot) {
  const float c = cosf(rot), s = sinf(rot);
  return {c * w.x + s * w.y, (-s) * w.x + c * w.y, w.z};
}

__device__ __forceinline__ float ggx_ndf(V3 h, float ax, float ay) {
  const float hx = h.x / ax, hy = h.y / ay;
  const float d = (hx * hx + hy * hy) + h.z * h.z;
  return h.z > 0.0f ? 1.0f / (((PI_F * ax) * ay) * clamp_min(d * d, 1e-12f))
                    : 0.0f;
}

__device__ __forceinline__ float smith_lambda(V3 w, float ax, float ay) {
  const float wx = w.x * ax, wy = w.y * ay;
  const float az2 = wx * wx + wy * wy;
  const float wz2 = w.z * w.z;
  return 0.5f * (sqrtf(1.0f + az2 / clamp_min(wz2, 1e-12f)) - 1.0f);
}

__device__ __forceinline__ float smith_g2(V3 wo, V3 wi, float ax, float ay) {
  return 1.0f / ((1.0f + smith_lambda(wo, ax, ay)) + smith_lambda(wi, ax, ay));
}

__device__ __forceinline__ float vndf_pdf(V3 wo, V3 h, float ax, float ay) {
  const float d = ggx_ndf(h, ax, ay);
  const float g1 = 1.0f / (1.0f + smith_lambda(wo, ax, ay));
  const float doth = clamp_min(dot(wo, h), 0.0f);
  return ((g1 * d) * doth) / clamp_min(fabsf(wo.z), 1e-9f);
}

__device__ __forceinline__ V3 reflect_local(V3 wo, V3 h) {
  const float d2 = 2.0f * dot(wo, h);
  return {d2 * h.x - wo.x, d2 * h.y - wo.y, d2 * h.z - wo.z};
}

// refract wo about h, eta = n_incident / n_transmitted
__device__ __forceinline__ V3 refract_local(V3 wo, V3 h, float eta, bool& tir) {
  const float cos_i = dot(wo, h);
  const float sin2_t = (eta * eta) * clamp_min(1.0f - cos_i * cos_i, 0.0f);
  tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(clampf(1.0f - sin2_t, 0.0f, 1.0f));
  const float k = eta * cos_i - cos_t;
  return normalize({(-wo.x) * eta + h.x * k, (-wo.y) * eta + h.y * k,
                    (-wo.z) * eta + h.z * k});
}

// classic VNDF sampling (Heitz 2018)
__device__ V3 sample_vndf(V3 wo, float ax, float ay, float u1, float u2) {
  const V3 vh = normalize({ax * wo.x, ay * wo.y, wo.z});
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  V3 t1 = {1.0f, 0.0f, 0.0f};
  if (lensq > F32(1e-9)) {
    const float l = sqrtf(clamp_min(lensq, 1e-12f));
    t1 = {(-vh.y) / l, vh.x / l, 0.0f / l};
  }
  const V3 t2 = cross(vh, t1);
  const float r = sqrtf(u1);
  const float phi = TWO_PI_F * u2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(clamp_min((1.0f - p1 * p1) - p2 * p2, 0.0f));
  const V3 nh = {(p1 * t1.x + p2 * t2.x) + p3 * vh.x,
                 (p1 * t1.y + p2 * t2.y) + p3 * vh.y,
                 (p1 * t1.z + p2 * t2.z) + p3 * vh.z};
  return normalize({ax * nh.x, ay * nh.y, clamp_min(nh.z, F32(1e-9))});
}

// visible normal by the spherical-caps method (Dupuy & Benyoub 2023)
__device__ V3 sample_vndf_caps(V3 wo, float ax, float ay, float u1, float u2) {
  const V3 vh = normalize({ax * wo.x, ay * wo.y, wo.z});
  const float phi = TWO_PI_F * u1;
  const float z = (1.0f - u2) * (1.0f + vh.z) - vh.z;
  const float sin_t = sqrtf(clampf(1.0f - z * z, 0.0f, 1.0f));
  const V3 c = {sin_t * cosf(phi) + vh.x, sin_t * sinf(phi) + vh.y, z + vh.z};
  return normalize({ax * c.x, ay * c.y, clamp_min(c.z, F32(1e-9))});
}

// ---------------------------------------------- the fits and the tables

// principled.py:_glass_ess_poly; sel picks one of the four fits
__device__ float glass_ess_poly(const float* coef, float rough, float cos_o,
                                float ior, int sel) {
  const float ip = clampf((ior - 1.0f) * RECIP(1.5), 0.0f, 1.0f);
  const float* c = coef + kOffGlassPoly + sel * kGlassTerms;
  float out = 0.0f, ra = 1.0f;
  int k = 0;
#pragma unroll
  for (int a = 0; a < kGlassDR; ++a) {
    float cb = 1.0f;
#pragma unroll
    for (int b = 0; b < kGlassDC; ++b) {
      float ig = 1.0f;
#pragma unroll
      for (int g = 0; g < kGlassDI; ++g) {
        out = out + ((c[k] * ra) * cb) * ig;
        ++k;
        ig = ig * ip;
      }
      cb = cb * cos_o;
    }
    ra = ra * rough;
  }
  return clampf(out, 0.2f, 1.0f);
}

// principled.py:_ess_poly, the conductor fit
__device__ float ess_poly(const float* coef, float rough, float cos_o) {
  const float* c = coef + kOffCondPoly;
  float out = 0.0f, ra = 1.0f;
  int k = 0;
#pragma unroll
  for (int a = 0; a < kCondD; ++a) {
    float cb = 1.0f;
#pragma unroll
    for (int b = 0; b < kCondD; ++b) {
      out = out + (c[k] * ra) * cb;
      ++k;
      cb = cb * cos_o;
    }
    ra = ra * rough;
  }
  return clampf(out, 0.05f, 1.0f);
}

// torch.floor(x).to(int64) of a clamped, non-negative index (NaN: 0)
__device__ __forceinline__ int floor_index(float x) {
  return x == x ? (int)floorf(x) : 0;
}

// principled.py:_ess_lookup: bilinear in the baked conductor table
__device__ float ess_lookup(const float* __restrict__ tables, float rough,
                            float cos_o) {
  const float* tab = tables + kOffCondEss;
  const float r = clampf(rough * (float)kCondRes - 0.5f, 0.0f, kCondRes - 1.0f);
  const float c = clampf(cos_o * (float)kCondRes - 0.5f, 0.0f, kCondRes - 1.0f);
  const int r0 = floor_index(r), c0 = floor_index(c);
  const int r1 = min(r0 + 1, kCondRes - 1), c1 = min(c0 + 1, kCondRes - 1);
  const float fr = r - (float)r0, fc = c - (float)c0;
  return ((__ldg(tab + r0 * kCondRes + c0) * (1.0f - fr) * (1.0f - fc) +
           __ldg(tab + r0 * kCondRes + c1) * (1.0f - fr) * fc) +
          __ldg(tab + r1 * kCondRes + c0) * fr * (1.0f - fc)) +
         __ldg(tab + r1 * kCondRes + c1) * fr * fc;
}

// principled.py:_glass_ess_lookup: trilinear in the glass table `sel`
__device__ float glass_ess_lookup(const float* coef,
                                  const float* __restrict__ tables,
                                  float rough, float cos_o, float ior,
                                  int sel) {
  const float* iors = coef + kOffIors;
  int above = 0;
#pragma unroll
  for (int j = 0; j < kIors; ++j) above += ior >= iors[j];
  const int k = min(max(above - 1, 0), kIors - 2);
  const float i0 = iors[k], i1 = iors[k + 1];
  const float fi = clampf((ior - i0) / clamp_min(i1 - i0, F32(1e-6)), 0.0f, 1.0f);
  const float r = clampf(rough * (float)kGlassRes - 0.5f, 0.0f, kGlassRes - 1.0f);
  const float c = clampf(cos_o * (float)kGlassRes - 0.5f, 0.0f, kGlassRes - 1.0f);
  const int r0 = floor_index(r), c0 = floor_index(c);
  const int r1 = min(r0 + 1, kGlassRes - 1), c1 = min(c0 + 1, kGlassRes - 1);
  const float fr = r - (float)r0, fc = c - (float)c0;
  float bil[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* t =
        tables + kOffGlassEss + (sel * kIors + k + q) * kGlassRes * kGlassRes;
    bil[q] = ((__ldg(t + r0 * kGlassRes + c0) * (1.0f - fr) * (1.0f - fc) +
               __ldg(t + r0 * kGlassRes + c1) * (1.0f - fr) * fc) +
              __ldg(t + r1 * kGlassRes + c0) * fr * (1.0f - fc)) +
             __ldg(t + r1 * kGlassRes + c1) * fr * fc;
  }
  return bil[0] * (1.0f - fi) + bil[1] * fi;
}

// Ess of the glass fit or table `sel`
__device__ __forceinline__ float glass_ess(int flags, const float* coef,
                                          const float* __restrict__ tables,
                                          float rough, float cos_o, float ior,
                                          int sel) {
  return (flags & kCompensationExact)
             ? glass_ess_lookup(coef, tables, rough, cos_o, ior, sel)
             : glass_ess_poly(coef, rough, cos_o, ior, sel);
}

// ----------------------------------------------------------- the lobes

// the sheen LTC's (Ai, Bi, R) at (cos_theta_o, alpha)
__device__ void sheen_ltc_params(const float* coef, float cos_o, float alpha,
                                 float& Ai, float& Bi, float& R) {
  float Tc[kSheenDeg], Ta[kSheenDeg];
  const float tc = 2.0f * clampf(cos_o, 0.0f, 1.0f) - 1.0f;
  const float ta = 2.0f * clampf(alpha, 0.0f, 1.0f) - 1.0f;
  Tc[0] = 1.0f;
  Tc[1] = tc;
  Ta[0] = 1.0f;
  Ta[1] = ta;
#pragma unroll
  for (int k = 2; k < kSheenDeg; ++k) {
    Tc[k] = (2.0f * tc) * Tc[k - 1] - Tc[k - 2];
    Ta[k] = (2.0f * ta) * Ta[k - 1] - Ta[k - 2];
  }
  float out[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* co = coef + kOffSheen + ch * kSheenDeg * kSheenDeg;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kSheenDeg; ++i) {
      float row = 0.0f;
#pragma unroll
      for (int j = 0; j < kSheenDeg; ++j) row = row + co[i * kSheenDeg + j] * Ta[j];
      acc = acc + row * Tc[i];
    }
    out[ch] = acc;
  }
  Ai = clamp_min(out[0], F32(1e-3));
  Bi = out[1];
  R = clampf(out[2], 0.0f, 1.0f);
}

// cos and sin of the view azimuth
__device__ __forceinline__ void sheen_view_frame(V3 wo, float& c, float& s) {
  const float rho = sqrtf(wo.x * wo.x + wo.y * wo.y);
  const bool safe = rho > F32(1e-8);
  const float r = clamp_min(rho, F32(1e-8));
  c = safe ? wo.x / r : 1.0f;
  s = safe ? wo.y / r : 0.0f;
}

// the fitted-LTC sheen: f (scalar) and pdf
__device__ void sheen_lobe(const float* coef, V3 wo, V3 wi, float alpha,
                           float& f, float& pdf) {
  const bool valid = wo.z > F32(1e-6) && wi.z > F32(1e-6);
  float Ai, Bi, R, c, s;
  sheen_ltc_params(coef, wo.z, alpha, Ai, Bi, R);
  sheen_view_frame(wo, c, s);
  const float x = c * wi.x + s * wi.y;
  const float y = (-s) * wi.x + c * wi.y;
  const float z = wi.z;
  const float xp = x * Ai + z * Bi;
  const float yp = y * Ai;
  const float l2 = clamp_min((xp * xp + yp * yp) + z * z, 1e-12f);
  float Do = ((z * Ai) * Ai) / ((PI_F * l2) * l2);
  Do = (valid && Do > 0.0f && isfinite(Do)) ? Do : 0.0f;
  const float fs = (R * Do) / clamp_min(wi.z, F32(1e-8));
  f = valid ? fs : 0.0f;
  pdf = Do;
}

__device__ V3 sheen_sample(const float* coef, V3 wo, float alpha, float u1,
                           float u2) {
  float Ai, Bi, R, c, s;
  sheen_ltc_params(coef, wo.z, alpha, Ai, Bi, R);
  const float r = sqrtf(u1);
  const float phi = TWO_PI_F * u2;
  const float cx = r * cosf(phi), cy = r * sinf(phi);
  const float cz = sqrtf(clamp_min(1.0f - u1, 0.0f));
  const float inv_Ai = 1.0f / Ai;
  const V3 v = normalize({(cx - cz * Bi) * inv_Ai, cy * inv_Ai, cz});
  sheen_view_frame(wo, c, s);
  return {c * v.x - s * v.y, s * v.x + c * v.y, v.z};
}

// GGX reflection D G2 / (4 cos_o cos_i) without Fresnel, its VNDF pdf and
// <wo, h>
__device__ void ggx_reflection_lobe(V3 wo, V3 wi, float ax, float ay,
                                    float& spec, float& pdf, float& cos_h) {
  const bool valid = wo.z > F32(1e-6) && wi.z > F32(1e-6);
  V3 h = normalize(wo + wi);
  if (h.z < 0.0f) h = -h;
  const float d = ggx_ndf(h, ax, ay);
  const float g2 = smith_g2(wo, wi, ax, ay);
  const float denom = 4.0f * clamp_min(wo.z * wi.z, F32(1e-9));
  spec = valid ? (d * g2) / denom : 0.0f;
  cos_h = dot(wo, h);
  const float doth = clamp_min(cos_h, F32(1e-9));
  pdf = valid ? vndf_pdf(wo, h, ax, ay) / (4.0f * doth) : 0.0f;
}

// Oren-Nayar diffuse: the scalar fr (f = base_color fr where `valid`, else
// 0) and pdf
__device__ void diffuse_lobe(float sigma, V3 wo, V3 wi, float& fr, bool& valid,
                             float& pdf) {
  const float cos_o = wo.z, cos_i = wi.z;
  valid = cos_i > F32(1e-6) && cos_o > F32(1e-6);
  const float s2 = sigma * sigma;
  const float A = 1.0f - (0.5f * s2) / (s2 + F32(0.33));
  const float B = (F32(0.45) * s2) / (s2 + F32(0.09));
  const float sin_o = sqrtf(clamp_min(1.0f - cos_o * cos_o, 0.0f));
  const float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, 0.0f));
  const float denom = clamp_min(sin_i * sin_o, F32(1e-7));
  const float cos_dphi =
      clampf((wi.x * wo.x + wi.y * wo.y) / denom, -1.0f, 1.0f);
  const float sin_alpha = maximum(sin_i, sin_o);
  const float tan_beta =
      minimum(sin_i, sin_o) / clamp_min(minimum(cos_i, cos_o), F32(1e-7));
  fr = INV_PI_F * (A + ((B * clamp_min(cos_dphi, 0.0f)) * sin_alpha) * tan_beta);
  pdf = valid ? cos_i * INV_PI_F : 0.0f;
}

// rough dielectric (Walter et al. 2007), reflection and refraction; eta =
// n_transmitted / n_incident. f_scalar is tinted by base_color where
// `refract` (set) is true.
__device__ void glass_lobe(V3 wo, V3 wi, float ax, float ay, float eta,
                           float& f_scalar, float& pdf, bool& refract) {
  const float cos_o = wo.z, cos_i = wi.z;
  const bool is_reflect = cos_i > 0.0f;
  V3 h;
  if (is_reflect) {
    h = normalize(wo + wi);
  } else {
    h = normalize(-(wo + scale(eta, wi)));
  }
  if (h.z < 0.0f) h = -h;
  const float doth_o = dot(wo, h);
  const float doth_i = dot(wi, h);
  const float F = fresnel_dielectric(fabsf(doth_o), eta);
  const float d = ggx_ndf(h, ax, ay);
  const float g2 = smith_g2(wo, is_reflect ? wi : -wi, ax, ay);
  const float vpdf = vndf_pdf(wo, h, ax, ay);
  const float cc = clamp_min(fabsf(cos_o * cos_i), F32(1e-9));
  float fs, ps;
  if (is_reflect) {
    fs = ((F * d) * g2) / (4.0f * cc);
    ps = (F * vpdf) / (4.0f * clamp_min(fabsf(doth_o), F32(1e-9)));
  } else {
    const float j = doth_o + eta * doth_i;
    const float jac = clamp_min(j * j, 1e-12f);
    const float common = (((fabsf(doth_o * doth_i) / cc) * d) * g2) / jac;
    fs = (1.0f - F) * common;
    const float jac_t = ((eta * eta) * fabsf(doth_i)) / jac;
    ps = ((1.0f - F) * vpdf) * jac_t;
  }
  const bool valid_o = cos_o > F32(1e-6);
  f_scalar = valid_o ? fs : 0.0f;
  pdf = valid_o ? ps : 0.0f;
  refract = !is_reflect;
}

// thin_film.py:_amp_reflectance
__device__ __forceinline__ float amp_reflectance(float cos_i, float n_from,
                                                 float n_to) {
  const float F = fresnel_dielectric(cos_i, n_to / n_from);
  const float sign = n_to > n_from ? -1.0f : 1.0f;
  return sign * sqrtf(clampf(F, 0.0f, 1.0f));
}

// thin_film.py:thin_film_reflectance, outside IOR 1
__device__ void thin_film_reflectance(float cos_theta0, float film_ior,
                                      float thickness, float base_ior,
                                      float hue_shift, float out[3]) {
  const float n0 = 1.0f;
  const float n1 = clamp_min(film_ior, ETA_MIN);
  const float n2 = clamp_min(base_ior, ETA_MIN);
  const float cos0 = clampf(cos_theta0, F32(1e-4), 1.0f);
  const float sin0 = sqrtf(clamp_min(1.0f - cos0 * cos0, 0.0f));
  const float sin1 = clampf((n0 / n1) * sin0, 0.0f, 1.0f);
  const float cos1 = sqrtf(clamp_min(1.0f - sin1 * sin1, 0.0f));
  const float r12 = amp_reflectance(cos0, n0, n1);
  const float r23 = amp_reflectance(cos1, n1, n2);
  const float opd = ((2.0f * n1) * thickness) * cos1;
  const float shift = 1.0f + hue_shift * RECIP(360.0);
  const float lambdas[3] = {650.0f, 550.0f, 440.0f};
  const float rr = r12 * r23;
  const float sq = (r12 * r12 + r23 * r23);
  const float rr2 = rr * rr;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lam_eff = lambdas[k] * shift;
    const float phi = (TWO_PI_F * opd) / clamp_min(lam_eff, 1.0f);
    const float c = cosf(phi);
    const float x = ((2.0f * r12) * r23) * c;
    const float num = sq + x;
    const float den = (1.0f + rr2) + x;
    out[k] = clampf(num / clamp_min(den, F32(1e-6)), 0.0f, 1.0f);
  }
}

// ------------------------------------------------------------ a lane

struct Mat {
  float s[sf::kCount];
  float c[cf::kCount][3];
};

__device__ __forceinline__ void load_mat(const Fields& p, int64_t i, Mat& m) {
#pragma unroll
  for (int k = 0; k < sf::kCount; ++k) m.s[k] = p.s[k][i];
#pragma unroll
  for (int k = 0; k < cf::kCount; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m.c[k][j] = p.c[k][3 * i + j];
  }
}

#define S(name) m.s[sf::name]
#define C(name) m.c[cf::name]

// principled.py:_lobe_setup: the six lobes' sampling probabilities
__device__ void lobe_setup(const Mat& m, V3 wo, float probs[6]) {
  const float cos_o = fabsf(wo.z);
  const float trans = S(specular_transmission);
  const float w_glass = (1.0f - S(metallic)) * trans;
  const float w_base = (1.0f - S(metallic)) * (1.0f - trans);
  const float F_spec =
      fresnel_dielectric(cos_o, clamp_min(S(ior), ETA_MIN)) * S(specular);
  const float Fc = fresnel_dielectric(cos_o, clamp_min(S(coat_ior), ETA_MIN));
  float fm[3];
  f82_tint(C(base_color), C(metallic_F82), C(metallic_F90),
           S(metallic_F90_falloff_exponent), cos_o, fm);
  float p[6];
  p[0] = S(coat) * Fc;
  p[1] = S(sheen) * F32(0.08);
  p[2] = S(metallic) * clamp_min(lum(fm), F32(0.05));
  p[3] = w_glass;
  p[4] = w_base * F_spec;
  p[5] = (w_base * (1.0f - F_spec)) * clamp_min(lum(C(base_color)), F32(0.05));
  const float total =
      clamp_min(((((p[0] + p[1]) + p[2]) + p[3]) + p[4]) + p[5], F32(1e-8));
#pragma unroll
  for (int k = 0; k < 6; ++k) probs[k] = p[k] / total;
}

// principled.py:_eval_lobes: f of every lobe blended by its weight, and
// each lobe's pdf (coat, sheen, metal, glass, specular, diffuse)
__device__ void eval_lobes(const Mat& m, int flags, const float* coef,
                           const float* __restrict__ tables, V3 wo, V3 wi,
                           float eta_rel, float f_total[3], float pdfs[6]) {
  const bool ec = flags & kEnergyCompensation;
  const float rot = S(anisotropy_rotation) * PI_F;
  wo = anisotropy_rotate(wo, rot);
  wi = anisotropy_rotate(wi, rot);
  float ax, ay, cax, cay;
  get_alphas(S(roughness), S(anisotropy), ax, ay);
  get_alphas(S(coat_roughness), S(coat_anisotropy), cax, cay);
  const float cos_o = fabsf(wo.z);
  const float cos_i_abs = fabsf(wi.z);
  const float coat_eta = clamp_min(S(coat_ior), ETA_MIN);

  // coat: white dielectric GGX reflection
  float spec_c, cosh_c;
  ggx_reflection_lobe(wo, wi, cax, cay, spec_c, pdfs[0], cosh_c);
  const float f_coat =
      spec_c * fresnel_dielectric(clamp_min(cosh_c, 0.0f), coat_eta);

  // coat attenuation of everything below
  const float Fc_o = fresnel_dielectric(cos_o, coat_eta);
  const float Fc_i = fresnel_dielectric(cos_i_abs, coat_eta);
  const float coat_att =
      1.0f - S(coat) * ((0.5f * (Fc_o + Fc_i)) * S(coat_darkening));
  const float coat_path =
      (S(coat_medium_thickness) * F32(0.01)) *
      (1.0f / clamp_min(cos_o, 0.1f) + 1.0f / clamp_min(cos_i_abs, 0.1f));
  float att_rgb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float tint =
        expf(logf(clampf(C(coat_medium_absorption)[k], F32(1e-3), 1.0f)) *
             coat_path);
    att_rgb[k] = coat_att * ((1.0f - S(coat)) + S(coat) * tint);
  }

  // sheen
  float f_sh;
  sheen_lobe(coef, wo, wi, S(sheen_roughness), f_sh, pdfs[1]);

  // metal: two GGX lobes (second roughness) sharing the Fresnel
  float spec_m1, pdf_m1, cosh_m, spec_m2, pdf_m2, cosh_m2, ax2, ay2;
  ggx_reflection_lobe(wo, wi, ax, ay, spec_m1, pdf_m1, cosh_m);
  get_alphas(S(second_roughness), S(anisotropy), ax2, ay2);
  ggx_reflection_lobe(wo, wi, ax2, ay2, spec_m2, pdf_m2, cosh_m2);
  const float w2 = S(second_roughness_weight);
  const float spec_m = (1.0f - w2) * spec_m1 + w2 * spec_m2;
  pdfs[2] = (1.0f - w2) * pdf_m1 + w2 * pdf_m2;
  const float cosh_m0 = clamp_min(cosh_m, 0.0f);
  float F_metal[3];
  f82_tint(C(base_color), C(metallic_F82), C(metallic_F90),
           S(metallic_F90_falloff_exponent), cosh_m0, F_metal);
  if (flags & kThinFilm) {
    const float tf_base = S(thin_film_do_ior_override) > 0.5f
                              ? S(thin_film_base_ior_override)
                              : clamp_min(S(ior), ETA_MIN);
    float F_tf[3];
    thin_film_reflectance(cosh_m0, S(thin_film_ior), S(thin_film_thickness),
                          tf_base, S(thin_film_hue_shift_degrees), F_tf);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      F_metal[k] = (1.0f - S(thin_film)) * F_metal[k] + S(thin_film) * F_tf[k];
  }
  float f_metal[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) f_metal[k] = spec_m * F_metal[k];
  if (ec) {
    // Turquin 2019: boost by (1 - E) / E, E = sqrt(Ess(mu_o) Ess(mu_i))
    float E_o, E_i;
    if (flags & kCompensationExact) {
      E_o = ess_lookup(tables, S(roughness), fabsf(wo.z));
      E_i = ess_lookup(tables, S(roughness), fabsf(wi.z));
    } else {
      E_o = ess_poly(coef, S(roughness), fabsf(wo.z));
      E_i = ess_poly(coef, S(roughness), fabsf(wi.z));
    }
    const float E = sqrtf(clampf(E_o * E_i, F32(1e-3), 1.0f));
    const float q = (1.0f - E) / E;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      f_metal[k] = f_metal[k] * (1.0f + C(base_color)[k] * q);
  }

  // glass: a thin-walled surface transmits straight through (eta ~ 1) with
  // the remapped roughness of a double interface
  const float r_thin = thin_walled_roughness(S(thin_walled), S(roughness),
                                             clamp_min(eta_rel, ETA_MIN));
  const bool thin = S(thin_walled) > 0.5f;
  float ax_g = ax, ay_g = ay;
  if (thin) get_alphas(r_thin, S(anisotropy), ax_g, ay_g);
  const float eta_g = thin ? ETA_MIN : eta_rel;
  float f_gs;
  bool refract;
  glass_lobe(wo, wi, ax_g, ay_g, eta_g, f_gs, pdfs[3], refract);
  float f_glass[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) f_glass[k] = f_gs * (refract ? C(base_color)[k] : 1.0f);
  if (ec) {
    const float ior_key = clamp_min(
        maximum(eta_rel, 1.0f / clamp_min(eta_rel, F32(1e-3))), ETA_MIN);
    const int sel = thin ? 2 : (eta_rel >= 1.0f ? 0 : 1);
    // keyed on wo only (wi lies on the other side of the interface)
    const float Eg = clampf(glass_ess(flags, coef, tables,
                                      thin ? r_thin : S(roughness),
                                      fabsf(wo.z), ior_key, sel),
                            F32(1e-2), 1.0f);
    const float inv = 1.0f / Eg;
#pragma unroll
    for (int k = 0; k < 3; ++k) f_glass[k] = f_glass[k] * inv;
  }

  // specular dielectric reflection on the base
  const float ior_b = clamp_min(S(ior), ETA_MIN);
  const float F_s_h = fresnel_dielectric(cosh_m0, ior_b);
  const float spec_s = (spec_m * F_s_h) * S(specular);
  float f_spec[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    f_spec[k] = spec_s * (C(specular_color)[k] * S(specular_tint) +
                          (1.0f - S(specular_tint)));
  pdfs[4] = pdfs[2];

  // diffuse under the specular layer, with (1 - F) on both sides
  const float Fo = fresnel_dielectric(cos_o, ior_b);
  const float Fi = fresnel_dielectric(cos_i_abs, ior_b);
  float fr_d;
  bool valid_d;
  diffuse_lobe(S(oren_nayar_sigma), wo, wi, fr_d, valid_d, pdfs[5]);
  const float trans_d = (1.0f - Fo * S(specular)) * (1.0f - Fi * S(specular));
  float f_diff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    f_diff[k] = (valid_d ? C(base_color)[k] * fr_d : 0.0f) * trans_d;

  if (ec) {
    // glossy-base layer: boost specular + diffuse by the reciprocal of the
    // layer's albedo, lerped by `specular`, faded by thin film
    const float E_gb = clampf(
        glass_ess(flags, coef, tables, S(roughness), cos_o, ior_b, 3), 0.2f,
        1.0f);
    float boost = 1.0f / (1.0f + S(specular) * (E_gb - 1.0f));
    boost = boost + S(thin_film) * (1.0f - boost);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f_spec[k] = f_spec[k] * boost;
      f_diff[k] = f_diff[k] * boost;
    }
  }

  const float trans = S(specular_transmission);
  const float w_metal = S(metallic);
  const float w_glass = (1.0f - S(metallic)) * trans;
  const float w_base = (1.0f - S(metallic)) * (1.0f - trans);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float below = ((S(sheen) * (f_sh * C(sheen_color)[k]) +
                          w_metal * f_metal[k]) +
                         w_glass * f_glass[k]) +
                        w_base * (f_spec[k] + f_diff[k]);
    f_total[k] = S(coat) * f_coat + att_rgb[k] * below;
  }
  if (ec) {
    // clearcoat layer: boost the whole stack by the reciprocal of the
    // coat-over-base albedo, lerped by coat (1 - transmission)
    const float E_c = clampf(
        glass_ess(flags, coef, tables, S(coat_roughness), cos_o, coat_eta, 3),
        0.2f, 1.0f);
    const float w_cc = S(coat) * (1.0f - S(specular_transmission));
    float boost = 1.0f / (1.0f + w_cc * (E_c - 1.0f));
    boost = boost + S(thin_film) * (1.0f - boost);
#pragma unroll
    for (int k = 0; k < 3; ++k) f_total[k] = f_total[k] * boost;
  }
}

// sum(p * l for p, l in zip(probs, pdfs))
__device__ __forceinline__ float mixture_pdf(const float probs[6],
                                             const float pdfs[6]) {
  float pdf = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) pdf = pdf + probs[k] * pdfs[k];
  return pdf;
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int64_t i,
                                       const float v[3]) {
  p[3 * i] = v[0];
  p[3 * i + 1] = v[1];
  p[3 * i + 2] = v[2];
}

// stage the fits and the IOR grid; the caller synchronises
__device__ __forceinline__ void stage(float* sh,
                                      const float* __restrict__ tables) {
  for (int k = threadIdx.x; k < kStaged; k += blockDim.x) sh[k] = tables[k];
}

// the lane's relative IOR: the caller's, or ior clamped (principled.py:
// _eta_rel)
__device__ __forceinline__ float eta_of(const float* __restrict__ eta,
                                        const Mat& m, int64_t i) {
  return eta != nullptr ? eta[i] : clamp_min(S(ior), ETA_MIN);
}

// core/rng.py: the LCG step and the PCG output permutation, in uint32
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float next_float(uint32_t& s) {
  s = s * 747796405u + 2891336453u;
  return (float)(pcg_hash(s) >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
principled_eval_kernel(Fields p, const float* __restrict__ n,
                       const float* __restrict__ wo,
                       const float* __restrict__ wi,
                       const float* __restrict__ eta,
                       const float* __restrict__ tables, int flags,
                       int64_t count, float* __restrict__ f_out,
                       float* __restrict__ pdf_out) {
  __shared__ float coef[kStaged];
  stage(coef, tables);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += step) {
    Mat m;
    load_mat(p, i, m);
    const V3 nn = load3(n, i);
    const V3 wo_l = to_local(nn, load3(wo, i));
    const V3 wi_l = to_local(nn, load3(wi, i));
    float f[3], pdfs[6], probs[6];
    eval_lobes(m, flags, coef, tables, wo_l, wi_l, eta_of(eta, m, i), f, pdfs);
    lobe_setup(m, wo_l, probs);
    const float pdf = mixture_pdf(probs, pdfs);
    const bool good =
        isfinite(pdf) && isfinite(f[0]) && isfinite(f[1]) && isfinite(f[2]);
    const float out[3] = {good ? f[0] : 0.0f, good ? f[1] : 0.0f,
                          good ? f[2] : 0.0f};
    store3(f_out, i, out);
    pdf_out[i] = good ? pdf : 0.0f;
  }
}

// principled.py:sample: draw a lobe by its probability and one direction
// from it, then the full eval and the mixture pdf
__global__ void __launch_bounds__(kThreads)
principled_sample_kernel(Fields p, const float* __restrict__ n,
                         const float* __restrict__ wo,
                         const int64_t* __restrict__ rng,
                         const float* __restrict__ eta,
                         const float* __restrict__ tables, int flags,
                         int64_t count, int64_t* __restrict__ rng_out,
                         float* __restrict__ wi_out,
                         float* __restrict__ f_out,
                         float* __restrict__ pdf_out,
                         uint8_t* __restrict__ refracted_out,
                         int8_t* __restrict__ lobe_out) {
  __shared__ float coef[kStaged];
  stage(coef, tables);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += step) {
    Mat m;
    load_mat(p, i, m);
    const V3 nn = load3(n, i);
    const V3 wo_l = to_local(nn, load3(wo, i));
    const float eta_rel = eta_of(eta, m, i);
    float probs[6];
    lobe_setup(m, wo_l, probs);
    uint32_t s = (uint32_t)rng[i];
    const float u_sel = next_float(s);
    const float u1 = next_float(s);
    const float u2 = next_float(s);
    const float u3 = next_float(s);
    rng_out[i] = (int64_t)s;

    // the lobe CDF
    const float c0 = probs[0];
    const float c1 = c0 + probs[1];
    const float c2 = c1 + probs[2];
    const float c3 = c2 + probs[3];
    const float c4 = c3 + probs[4];
    const int lobe = u_sel < c0   ? 0
                     : u_sel < c1 ? 1
                     : u_sel < c2 ? 2
                     : u_sel < c3 ? 3
                     : u_sel < c4 ? 4
                                  : 5;

    const V3 wo_up = wo_l.z < 0.0f ? -wo_l : wo_l;
    V3 wi_l;
    if (lobe == 1) {
      wi_l = sheen_sample(coef, wo_up, S(sheen_roughness), u1, u2);
    } else if (lobe == 5) {
      const float r = sqrtf(u1);
      const float phi = TWO_PI_F * u2;
      wi_l = {r * cosf(phi), r * sinf(phi), sqrtf(clamp_min(1.0f - u1, 0.0f))};
    } else {
      // sample in the rotated tangent frame, rotate the result back
      const float rot = S(anisotropy_rotation) * PI_F;
      const V3 wo_rot = anisotropy_rotate(wo_up, rot);
      float ax, ay;
      if (lobe == 0) {
        get_alphas(S(coat_roughness), S(coat_anisotropy), ax, ay);
      } else {
        get_alphas(S(roughness), S(anisotropy), ax, ay);
      }
      const V3 h = (flags & kSphericalCaps)
                       ? sample_vndf_caps(wo_rot, ax, ay, u1, u2)
                       : sample_vndf(wo_rot, ax, ay, u1, u2);
      bool reflect = true;
      V3 wt;
      if (lobe == 3) {
        // glass: reflect or refract through h by Fresnel; thin-walled
        // surfaces use eta ~ 1 (straight through)
        const float eta_g = S(thin_walled) > 0.5f ? ETA_MIN : eta_rel;
        const float doth = clamp_min(dot(wo_rot, h), F32(1e-9));
        const float Fg = fresnel_dielectric(doth, eta_g);
        bool tir;
        wt = refract_local(wo_rot, h, 1.0f / eta_g, tir);
        reflect = u3 < Fg || tir;
      }
      wi_l = anisotropy_rotate(reflect ? reflect_local(wo_rot, h) : wt, -rot);
    }

    float f[3], pdfs[6];
    eval_lobes(m, flags, coef, tables, wo_up, wi_l, eta_rel, f, pdfs);
    const float pdf = mixture_pdf(probs, pdfs);
    const bool good = isfinite(pdf) && pdf > 0.0f && isfinite(f[0]) &&
                      isfinite(f[1]) && isfinite(f[2]);
    const float out[3] = {good ? f[0] : 0.0f, good ? f[1] : 0.0f,
                          good ? f[2] : 0.0f};
    store3(f_out, i, out);
    pdf_out[i] = good ? pdf : 0.0f;
    const V3 w = to_world(nn, wi_l);
    const float wv[3] = {w.x, w.y, w.z};
    store3(wi_out, i, wv);
    refracted_out[i] = lobe == 3 && wi_l.z < 0.0f;
    if (lobe_out != nullptr) lobe_out[i] = (int8_t)lobe;
  }
}

#undef S
#undef C

template <typename Kernel>
cudaError_t wave(Kernel kernel, int64_t count, int& blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  // one resident wave, or as many blocks as the lanes need
  const int64_t need = (count + kThreads - 1) / kThreads;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  blocks = (int)(need < resident ? need : resident);
  return err;
}

Fields fields_of(const void* const* ptrs) {
  Fields p;
  for (int k = 0; k < sf::kCount; ++k) p.s[k] = (const float*)ptrs[k];
  for (int k = 0; k < cf::kCount; ++k)
    p.c[k] = (const float*)ptrs[sf::kCount + k];
  return p;
}

}  // namespace

// Plain C interface for ctypes. `fields` is a host array of the material
// fields' device pointers (the scalars, then the colours, in the order of
// the enums above); every other pointer is a device pointer: n, wo, wi and
// wi_out (count, 3) f32; eta (count,) f32 or null (ior clamped); rng and
// rng_out (count,) int64 holding uint32 states; tables, the coefficient
// table of kTableFloats floats; refracted (count,) bool; lobe (count,)
// int8 or null; `stream` is a cudaStream_t. flags: kThinFilm ... Returns
// the first CUDA error of the launch, or 0. hpt_principled_info gives the
// eval (sample = 0) or sample kernel's registers per thread, local memory
// bytes per thread, static shared memory bytes per block and resident
// blocks per SM, for the records; hpt_principled_table_floats the table's
// length, which the wrapper checks.
extern "C" {

int hpt_principled_table_floats() { return kTableFloats; }

int hpt_principled_eval(const void* const* fields, const void* n,
                        const void* wo, const void* wi, const void* eta,
                        const void* tables, int flags, int64_t count, void* f,
                        void* pdf, void* stream) {
  if (count <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = wave(principled_eval_kernel, count, blocks);
  if (err != cudaSuccess) return (int)err;
  principled_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      fields_of(fields), (const float*)n, (const float*)wo, (const float*)wi,
      (const float*)eta, (const float*)tables, flags, count, (float*)f,
      (float*)pdf);
  return (int)cudaGetLastError();
}

int hpt_principled_sample(const void* const* fields, const void* n,
                          const void* wo, const void* rng, const void* eta,
                          const void* tables, int flags, int64_t count,
                          void* rng_out, void* wi, void* f, void* pdf,
                          void* refracted, void* lobe, void* stream) {
  if (count <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = wave(principled_sample_kernel, count, blocks);
  if (err != cudaSuccess) return (int)err;
  principled_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      fields_of(fields), (const float*)n, (const float*)wo,
      (const int64_t*)rng, (const float*)eta, (const float*)tables, flags,
      count, (int64_t*)rng_out, (float*)wi, (float*)f, (float*)pdf,
      (uint8_t*)refracted, (int8_t*)lobe);
  return (int)cudaGetLastError();
}

int hpt_principled_info(int sample, int* regs, int* local_bytes,
                        int* shared_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const void* fn = sample ? (const void*)principled_sample_kernel
                          : (const void*)principled_eval_kernel;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            kThreads, 0);
}

}  // extern "C"
