// The deterministic route's table scatter as the host plans and launches it
// (the kernels: hash_encode.cu, hash_encode_bwd_fx_kernel on hash_grid.cuh's
// scatter layer). The unfused backward's C entry and the train step's
// deterministic route (train_step.cu) both call fx_scatter.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// shared memory a block may give its int64 slab: the H100 offers a block
// 227 KB; what is left holds the block's other shared state
constexpr int FX_STAGE_BUDGET = 200 * 1024;

// One level's plan, made on the host from its rows, F and FX_STAGE_BUDGET:
//   's'  the level's rows x F int64 slab fits one block;
//   'c'  it fits split across a cluster of 2, 4 or 8 blocks (the fewest
//        that do), each block owning `span` consecutive rows;
//   'd'  no cluster of 8 holds it: every add straight to device memory.
// A slab block takes `points` consecutive points (a power of two in
// [1,024, 4,096], about as many as its slab has rows), a direct block 512,
// so the grid depends on N and the level's rows alone. `force` (0: the
// rule) takes a letter: 'd', 's', or 'c' + 256 x the cluster's blocks.
struct FxLevel {
  char site;
  int cluster;      // blocks of a cluster ('c'), else 1
  long long rows;   // the rows of its table the level uses
  int span;         // rows a block's slab holds ('s': rows; 'd': 0)
  int points;       // points a block takes
  int threads;      // threads a block
  int smem;         // the slab's bytes, span x F x 8
};

FxLevel fx_level_plan(int res, long long T, int F, int force);

// The scatter of every level (one launch a level) of the cotangent g
// (B,N,L*F), float32 or bfloat16 (g_bf16), at coords (B,N,3): row b into
// partition part[b] of grad_fx (P,L,T,F) int64 (part null: partition b),
// its flag bits into flags (P,). res and force (each L int32, force may be
// null) in host memory. Returns the first launch's error.
cudaError_t fx_scatter(const void* g, int g_bf16, const float* coords, const int* part,
                       const int* res, const int* force,
                       unsigned long long* grad_fx, unsigned long long* flags,
                       long long B, long long N, int L, long long T, int F, float vmax,
                       cudaStream_t stream);

}  // namespace repro
