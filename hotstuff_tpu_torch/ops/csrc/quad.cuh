// Point arithmetic with four threads per point (a quad): the 4-bit-window
// Straus ladder of K1 (ladder.cu) and K5 (committee_ladder.cu), and the
// mixed additions of K3's table (decompress_table.cu).
//
// Thread k of a quad owns coordinate k of the extended accumulator
// (0 X, 1 Y, 2 Z, 3 T): the 4-way parallel form of the extended
// twisted-Edwards formulas (Hisil, Wong, Carter, Dawson, "Twisted Edwards
// curves revisited", ASIACRYPT 2008). Every point op of the ladder is two
// stages of four independent field multiplies:
//
//   op          stage 1 (thread 0, 1, 2, 3)           stage 2 (thread 0, 1, 2, 3)
//   dbl         X^2, Y^2, Z^2, (X+Y)^2                xp*tp, yp*zp, zp*tp, xp*yp
//   madd        (Y+X)*ypx, (Y-X)*ymx, T*xy2d, -       x3*t3, y3*z3, z3*t3, x3*y3
//   add cached  (Y+X)*ypx, (Y-X)*ymx, T*t2d, Z*z      x3*t3, y3*z3, z3*t3, x3*y3
//
// so a group (4 doublings, 2 additions) is 12 multiply stages on each
// thread's chain instead of 43 field operations on one thread's. Between
// the stages the quad exchanges its 10-limb results (quad_xchg), and each
// thread forms the sums it needs with fe_add / fe_sub. Each thread calls
// fe_mul / fe_sq on the same inputs as the one-point formulas of the plain
// versions (ops/ed25519.py point_dbl, point_madd, point_add_cached, run by
// ops/ladder.py and ops/committee.py), so the result equals them limb for
// limb, and the sums that feed a multiply are the ones whose bounds
// field.cuh states.
//
// T is computed by every op (thread 3 would otherwise idle in the stage 2
// of the doublings that skip it); no doubling reads T, so X, Y, Z do not
// change. The stored T is zeros, as the plain versions return it.
//
// Lanes: signature `lane` of a block is quad threadIdx.x / 4. A quad whose
// lane is past the batch computes on the last lane (every exchange's
// __syncwarp needs all 32 threads) and skips its stores.
#pragma once

#include "field.cuh"

#define HS_QUAD_THREADS 32  // one warp: K1 and K5 blocks of 8 signatures (a 128-lane bucket spans 16 SMs)
#define HS_QUAD_LANES (HS_QUAD_THREADS / 4)
#define HS_SLOT 12             // int32 per thread's exchange slot (10 limbs, 16-byte aligned)

// One thread's place in its quad.
struct quad_pos {
  int k;      // coordinate owned: 0 X, 1 Y, 2 Z, 3 T
  int lane0;  // warp lane of the quad's thread 0
};

__device__ __forceinline__ quad_pos quad_here() {
  const int t = threadIdx.x & 31;
  return quad_pos{t & 3, t & ~3};
}

// The exchange between stages: put() publishes this thread's element,
// get(j) reads the element of thread j of the quad.
// Through a per-warp shared-memory area of HS_QUAD_THREADS slots. On an H100
// it issued 5% fewer instructions per group than an exchange by __shfl_sync
// (STS/LDS.128 against 340 SHFL) and took less time (PERF.md, section 6).
struct quad_xchg {
  int32_t* mine;
  const int32_t* quad0;
  __device__ __forceinline__ quad_xchg(int32_t* slots, const quad_pos& q) {
    mine = slots + (threadIdx.x & 31) * HS_SLOT;
    quad0 = slots + q.lane0 * HS_SLOT;
  }
  __device__ __forceinline__ void put(const fe& a) {
    __syncwarp();  // every read of the previous exchange is done
    int4* p = reinterpret_cast<int4*>(mine);
    p[0] = make_int4(a.v[0], a.v[1], a.v[2], a.v[3]);
    p[1] = make_int4(a.v[4], a.v[5], a.v[6], a.v[7]);
    reinterpret_cast<int2*>(mine)[4] = make_int2(a.v[8], a.v[9]);
    __syncwarp();
  }
  __device__ __forceinline__ fe get(int j) const {
    const int32_t* s = quad0 + j * HS_SLOT;
    const int4 a = reinterpret_cast<const int4*>(s)[0];
    const int4 b = reinterpret_cast<const int4*>(s)[1];
    const int2 c = reinterpret_cast<const int2*>(s)[4];
    return fe_const(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y);
  }
};

// Stage 2 of every op, from (P0, P1, P2, P3) = dbl (xp, yp, zp, tp), add
// (x3, y3, z3, t3): X = P0*P3, Y = P1*P2, Z = P2*P3, T = P0*P1.
__device__ __forceinline__ fe quad_stage2(const quad_pos& q, const fe& p0, const fe& p1,
                                          const fe& p2, const fe& p3) {
  const fe u = fe_select(q.k == 1, p1, fe_select(q.k == 2, p2, p0));
  const fe v = fe_select(q.k == 1, p2, fe_select(q.k == 3, p1, p3));
  return fe_mul(u, v);
}

// dbl-2008-hwcd for a = -1 (point_dbl): c is this thread's coordinate.
__device__ __forceinline__ fe quad_dbl(const quad_pos& q, quad_xchg& x, const fe& c) {
  x.put(c);
  const fe u = fe_select(q.k == 3, fe_add(x.get(0), x.get(1)), c);
  x.put(fe_sq(u));  // xx, yy, zz, aa
  const fe xx = x.get(0), yy = x.get(1), zz = x.get(2), aa = x.get(3);
  const fe zz2 = fe_add(zz, zz);
  const fe yp = fe_add(yy, xx);
  const fe zp = fe_sub(yy, xx);
  const fe xp = fe_sub(aa, yp);
  const fe tp = fe_sub(zz2, zp);
  return quad_stage2(q, xp, yp, zp, tp);
}

// The pair exchange that opens an addition: from this thread's coordinate
// c, the operand of its stage-1 multiply, Y+X, Y-X, T, Z on thread 0, 1,
// 2, 3 (thread 0 gets Y, 1 X, 2 T, 3 Z).
__device__ __forceinline__ fe quad_add_operand(const quad_pos& q, quad_xchg& x, const fe& c) {
  x.put(c);
  const fe o = x.get(q.k ^ 1);
  return fe_select(q.k == 0, fe_add(o, c), fe_select(q.k == 1, fe_sub(c, o), o));
}

// The rest of an addition from stage 1's results m: a, b, c on threads
// 0-2 and zz on thread 3 (madd: Z itself; cached: Z*z).
__device__ __forceinline__ fe quad_add_finish(const quad_pos& q, quad_xchg& x, const fe& m) {
  x.put(m);
  const fe a = x.get(0), b = x.get(1), cc = x.get(2), zz = x.get(3);
  const fe d2z = fe_add(zz, zz);
  const fe x3 = fe_sub(a, b);
  const fe y3 = fe_add(a, b);
  const fe z3 = fe_add(d2z, cc);
  const fe t3 = fe_sub(d2z, cc);
  return quad_stage2(q, x3, y3, z3, t3);
}

// madd-2008-hwcd-3 (CACHED = false, point_madd) or add-2008-hwcd-3
// (CACHED = true, point_add_cached). e is this thread's table coordinate:
// madd (y+x, y-x, 2d*x*y, unused), cached (y+x, y-x, 2d*t, z).
template <bool CACHED>
__device__ __forceinline__ fe quad_add(const quad_pos& q, quad_xchg& x, const fe& c, const fe& e) {
  const fe u = quad_add_operand(q, x, c);
  const fe m = fe_mul(u, e);
  return quad_add_finish(q, x, CACHED ? m : fe_select(q.k == 3, u, m));
}

// The table coordinate thread k multiplies in stage 1 of each addition.
__device__ __forceinline__ int quad_affine_coord(const quad_pos& q) { return q.k < 2 ? q.k : 2; }
__device__ __forceinline__ int quad_cached_coord(const quad_pos& q) { return q.k ^ (q.k >> 1); }

// The 64-group ladder [s]B + [h]Q for the signature at `lane` (< batch).
// xslots: the block's exchange area, HS_QUAD_THREADS * HS_SLOT int32,
// 16-byte aligned, in shared memory. Per group: 4 doublings, a mixed add
// of the k*B entry for the s digit (sbase: (3, 16, 10) int32 in shared
// memory), then an add of the per-item entry for the h digit. Item has
//   fe load(int h) const           this thread's coordinate of that entry
//   static constexpr bool CACHED   the add is a cached add (else mixed)
// Group g+1's entry and digits are loaded while group g computes (a
// register prefetch: the digits of all groups are known up front).
// Returns this thread's coordinate of the result (T not zeroed).
template <class Item>
__device__ __forceinline__ fe quad_ladder(const quad_pos& q, int32_t* xslots,
                                          const int32_t* sbase, const uint8_t* __restrict__ sd,
                                          const uint8_t* __restrict__ hd, int lane, int batch,
                                          const Item& item) {
  quad_xchg x(xslots, q);
  const int32_t* bcoord = sbase + quad_affine_coord(q) * 16 * HS_NL;
  fe c = (q.k == 1 || q.k == 2) ? fe_one() : fe_zero();
  int s = __ldg(sd + (size_t)63 * batch + lane);
  int h = __ldg(hd + (size_t)63 * batch + lane);
  int s1 = __ldg(sd + (size_t)62 * batch + lane);
  int h1 = __ldg(hd + (size_t)62 * batch + lane);
  fe e = item.load(h);
#pragma unroll 1
  for (int row = 63; row >= 0; row--) {
    const fe e_next = item.load(h1);  // row - 1's entry (row 0: unused)
    const size_t r2 = (size_t)(row >= 2 ? row - 2 : 0) * batch + lane;
    const int s2 = __ldg(sd + r2), h2 = __ldg(hd + r2);
    c = quad_dbl(q, x, c);
    c = quad_dbl(q, x, c);
    c = quad_dbl(q, x, c);
    c = quad_dbl(q, x, c);
    c = quad_add<false>(q, x, c, load_fe(bcoord + s * HS_NL, 1));
    c = quad_add<Item::CACHED>(q, x, c, e);
    e = e_next;
    s = s1, s1 = s2;
    h1 = h2;
  }
  return c;
}

// Store this thread's coordinate of a (4, 10, B) result; T as zeros.
__device__ __forceinline__ void quad_store(const quad_pos& q, int32_t* out, int lane, int batch,
                                           const fe& c) {
  store_fe(out + (size_t)q.k * HS_NL * batch + lane, batch, q.k == 3 ? fe_zero() : c);
}
