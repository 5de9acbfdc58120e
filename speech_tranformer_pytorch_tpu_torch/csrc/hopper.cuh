// Hopper (sm_90a) building blocks shared by the port's kernels: cp.async
// copies into shared memory, thread-block cluster barriers, mbarriers and
// st.async stores into another block's shared memory, the 128-byte
// swizzled tile layout that wgmma reads, wgmma matrix descriptors and the
// wgmma instructions themselves (inline PTX; the forms follow the PTX
// ISA's sections of the same names).
//
// Tile layout. A bf16 tile of `rows` rows and 64·n columns is stored as n
// column blocks of [rows][64]; each 128-byte row of a block holds eight
// 16-byte chunks, chunk c at position c ^ (row % 8). Blocks start 1024-byte
// aligned. wgmma reads such a tile either way round:
//  * K-major (desc_k_major): rows are the M (or N) index, columns the K
//    index, as for A = K and B = Qᵀ in S = K Qᵀ;
//  * MN-major (desc_mn_major, B only): rows are the K index, columns the N
//    index, as for B = dO in dV = Pᵀ dO.
// So one copy of a tile serves both products that read it.
//
// Register fragments. The f32 accumulator of an m64nN wgmma gives thread
// `lane` of warp `w` (of the warpgroup) the values d[i], i < N / 2, at
//   row 16 w + lane / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (lane % 4) + i % 2,
// and the bf16 A fragment of one k16 step is the same layout over 16
// columns: the accumulator's values 8 s .. 8 s + 7, rounded and packed in
// pairs, are the A operand of k-step s. That is how P and dS go from one
// product into the next without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace st {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory; when !valid nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups of this thread are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later reads by the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------- clusters and mbarriers
// A thread-block cluster's barrier, split so that work runs between the
// arrive and the wait; every thread of every block of the cluster calls
// both. Release/acquire order what came before the arrive (an mbarrier's
// initialisation) with what comes after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of the variable at shared address `addr`
// in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// An mbarrier of `count` arrivals, made visible to the cluster.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n" :: "r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of asynchronous stores.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// 16 bytes to the shared memory of another block of the cluster (`dst`
// and `bar` from map_rank); their arrival completes 16 bytes of `bar`'s
// expected transactions.
__device__ __forceinline__ void st_async_16(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

// ------------------------------------------------------ swizzled tiles
// Byte offset of 16-byte chunk `chunk` (8 bf16 columns) of row `row` in a
// tile of `rows` rows laid out as above.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk, int rows) {
  return (chunk >> 3) * rows * 128 + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// The 16 K-columns of k-step `ks` of a K-major tile: 32 bytes further in
// the row for each step, the next column block every four steps. Eight
// rows (1024 bytes) per stride step; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * 128 + (ks & 3) * 32, 16, 1024);
}

// The 16 K-rows of k-step `ks` of an MN-major tile: 16 rows (2048 bytes)
// further for each step; 8 K-rows per stride step (1024 bytes), the next
// 64 N-columns one column block (rows · 128 bytes) further.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int ks) {
  return sw128_desc(tile + ks * 2048, rows * 128, 1024);
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// The compiler sees a wgmma's accumulators as written when the instruction
// is issued; this pins every register of `r` at this point, so reads are
// not hoisted above a wgmma_wait nor writes sunk below the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// `accumulate` = 0 overwrites D. Issued by all 128 threads of a warpgroup.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] for N = 64 and N = 128 (the size of
// d): A a bf16 fragment in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_k16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_k16(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] B[16 x N] for N = 8, 16, ..., 64 (d holds N / 2
// values): A a bf16 fragment in registers, B K-major in shared memory (its
// rows are the N index), as for B = xᵀ in yᵀ = Wᵀ xᵀ. A, B and the
// predicate's source are in-out operands %0-%5, so the accumulator list of
// every N starts at %6 and is a prefix of the same list.
template <int N>
__device__ void wgmma_rs_k16_kmajor(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint64_t db);

#define ST_ACC_0 "%6, %7, %8, %9"
#define ST_ACC_1 ", %10, %11, %12, %13"
#define ST_ACC_2 ", %14, %15, %16, %17"
#define ST_ACC_3 ", %18, %19, %20, %21"
#define ST_ACC_4 ", %22, %23, %24, %25"
#define ST_ACC_5 ", %26, %27, %28, %29"
#define ST_ACC_6 ", %30, %31, %32, %33"
#define ST_ACC_7 ", %34, %35, %36, %37"
#define ST_D4(j) "+f"(d[4 * j]), "+f"(d[4 * j + 1]), "+f"(d[4 * j + 2]), "+f"(d[4 * j + 3])
#define ST_WGMMA_RS_KMAJOR(N, ACC, ...)                                                     \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_rs_k16_kmajor<N>(                                   \
      float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) { \
    int accumulate = 1;                                                                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" ACC           \
                 "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"                                \
                 : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(db), "+r"(accumulate),     \
                   __VA_ARGS__);                                                            \
  }
ST_WGMMA_RS_KMAJOR(8, ST_ACC_0, ST_D4(0))
ST_WGMMA_RS_KMAJOR(16, ST_ACC_0 ST_ACC_1, ST_D4(0), ST_D4(1))
ST_WGMMA_RS_KMAJOR(24, ST_ACC_0 ST_ACC_1 ST_ACC_2, ST_D4(0), ST_D4(1), ST_D4(2))
ST_WGMMA_RS_KMAJOR(32, ST_ACC_0 ST_ACC_1 ST_ACC_2 ST_ACC_3, ST_D4(0), ST_D4(1), ST_D4(2),
                   ST_D4(3))
ST_WGMMA_RS_KMAJOR(40, ST_ACC_0 ST_ACC_1 ST_ACC_2 ST_ACC_3 ST_ACC_4, ST_D4(0), ST_D4(1),
                   ST_D4(2), ST_D4(3), ST_D4(4))
ST_WGMMA_RS_KMAJOR(48, ST_ACC_0 ST_ACC_1 ST_ACC_2 ST_ACC_3 ST_ACC_4 ST_ACC_5, ST_D4(0),
                   ST_D4(1), ST_D4(2), ST_D4(3), ST_D4(4), ST_D4(5))
ST_WGMMA_RS_KMAJOR(56, ST_ACC_0 ST_ACC_1 ST_ACC_2 ST_ACC_3 ST_ACC_4 ST_ACC_5 ST_ACC_6,
                   ST_D4(0), ST_D4(1), ST_D4(2), ST_D4(3), ST_D4(4), ST_D4(5), ST_D4(6))
ST_WGMMA_RS_KMAJOR(64, ST_ACC_0 ST_ACC_1 ST_ACC_2 ST_ACC_3 ST_ACC_4 ST_ACC_5 ST_ACC_6 ST_ACC_7,
                   ST_D4(0), ST_D4(1), ST_D4(2), ST_D4(3), ST_D4(4), ST_D4(5), ST_D4(6),
                   ST_D4(7))
#undef ST_WGMMA_RS_KMAJOR
#undef ST_D4
#undef ST_ACC_0
#undef ST_ACC_1
#undef ST_ACC_2
#undef ST_ACC_3
#undef ST_ACC_4
#undef ST_ACC_5
#undef ST_ACC_6
#undef ST_ACC_7

}  // namespace st
