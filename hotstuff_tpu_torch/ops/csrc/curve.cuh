// ed25519 point arithmetic, one point per thread, on the field of field.cuh.
//
// Replaces the jnp curve code of hotstuff_tpu/ops/ed25519.py:120-178
// (point_madd), decompress (:561-588) and the cached -A table build
// (:242-264), which K3 runs. The steps, and so every limb, match
// ops/ed25519.py of this package. The ladders' doubling and additions, four
// threads per point, are in quad.cuh.
#pragma once

#include "field.cuh"

struct ge {
  fe X, Y, Z, T;
};

__device__ __forceinline__ ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

// madd-2008-hwcd-3: P + affine precomp (y+x, y-x, 2d*x*y).
template <bool WITH_T>
__device__ __forceinline__ ge ge_madd(const ge& p, const fe& ypx, const fe& ymx, const fe& xy2d) {
  const fe a = fe_mul(fe_add(p.Y, p.X), ypx);
  const fe b = fe_mul(fe_sub(p.Y, p.X), ymx);
  const fe c = fe_mul(p.T, xy2d);
  const fe d2z = fe_add(p.Z, p.Z);
  const fe x3 = fe_sub(a, b);
  const fe y3 = fe_add(a, b);
  const fe z3 = fe_add(d2z, c);
  const fe t3 = fe_sub(d2z, c);
  ge r;
  r.T = WITH_T ? fe_mul(x3, y3) : fe_zero();
  r.X = fe_mul(x3, t3);
  r.Y = fe_mul(y3, z3);
  r.Z = fe_mul(z3, t3);
  return r;
}

// Compressed y (value < 2^255; y >= p is reduced, not rejected) and the
// sign of x -> canonical x, -x and whether a square root exists.
__device__ __forceinline__ void ge_decompress(const fe& y, int sign, fe& x_out, fe& xneg_out,
                                              bool& valid) {
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, fe_one());
  const fe v = fe_add(fe_mul(fe_d(), yy), fe_one());
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  const fe w = fe_pow2523(fe_mul(u, v7));
  const fe r = fe_mul(fe_mul(u, v3), w);
  const fe chk = fe_canonical(fe_mul(v, fe_sq(r)));
  const fe u_c = fe_canonical(u);
  const fe negu_c = fe_canonical(fe_sub(fe_zero(), u));
  const bool is_pos = fe_eq(chk, u_c);
  const bool is_neg = fe_eq(chk, negu_c) && !is_pos;
  valid = is_pos || is_neg;
  const fe x = fe_select(is_neg, fe_mul(r, fe_sqrtm1()), r);
  const fe x_c = fe_canonical(x);
  const fe xneg_c = fe_canonical(fe_sub(fe_zero(), x_c));
  const bool flip = fe_parity(x_c) != sign;
  x_out = fe_select(flip, xneg_c, x_c);
  xneg_out = fe_select(flip, x_c, xneg_c);
}
