// The Franka-kitchen surrogate's control step (`envs/kitchen/env.py::
// kitchen_step`) as one kernel: one thread per env, the whole 12.5 Hz step
// in registers.
//
// It replaces no TPU kernel: `beso_tpu`'s step is jnp code that XLA fuses
// into a few kernels. Run eagerly, the port's step is some 360 elementwise
// operations on [B, 7, 3]-sized tensors, each a microsecond of device work
// behind several of host dispatch, and its numpy-indexed writes are
// host-to-device copies that wait for the stream: the card idles while the
// host issues them. The step's work is a few thousand floating-point
// operations per env, so what bounds it on this card is the launch, not
// bytes or operations. The design: one launch per step, no copy from the
// host, nothing the host waits for. The physics constants (`KitchenParams`,
// device tensors so that perturbed params work) and the env's tables
// (`_consts`: goal, task masks, joint and object limits, primary and
// secondary joints, the Panda's modified-DH table) are staged in shared
// memory at block start; each thread reads its env's state, steps it and
// writes the new state and the reward.
//
// The arithmetic is the eager step's, operation for operation, in f32 and
// in the same order: products and sums are rounded one at a time
// (__fmul_rn / __fadd_rn, which are never contracted into an FMA), as the
// separate eager operations round them, and sinf / cosf / atan2f / sqrtf
// are CUDA's precise ones that PyTorch's kernels call. Where one eager
// operation holds a product and a sum, the kernel contracts as it does:
// the forward kinematics' 4 x 4 products (cuBLAS) as a chain of FMAs, the
// cross products' first term. So on the card the kernel gives the eager
// step's bits (PERF.md).
//
// Per env: 30 qpos, the fingertip [3], per task a completion flag, an open
// flag and the completion step, the kettle latch, done and the step count
// in; the same out, plus the reward. Envs that were already done keep their
// state and get reward 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int NQ = 30;    // qpos
constexpr int NE = 7;     // elements (tasks); the last is the kettle
constexpr int NJ = 9;     // robot joints: 7 arm, 2 fingers
constexpr int NOBJ = 21;  // object joints, qpos 9..29
constexpr int NDH = 8;    // the 7 arm links and the fingertip
constexpr int KETTLE = 6;
constexpr int KETTLE_Q = 23;  // the kettle body's position, qpos 23..25

// The constants of a step, in shared memory.
struct Scene {
  // KitchenParams
  float pivots[NE][3], axes[NE][3], handle0[NE][3], bar_dirs[NE][3];
  float bar_halflen[NE], rotary[NE], drive_eff[NE];
  float interact_radius, grasp_radius, release_radius, grip_close, grip_open;
  float kettle_gain, kettle_max_speed, wall_y;
  float micro_lo[3], micro_hi[3];
  // the env's tables
  float goal[NQ], masks[NE][NQ];
  float joint_lo[NJ], joint_hi[NJ], obj_lo[NOBJ], obj_hi[NOBJ];
  int primary[NE], secondary[NE];
  float ratio[NE];
  float dh[NDH][5];  // a, cos alpha, sin alpha, d sin alpha, d cos alpha
  float base[3];
};

// The pointers, in the order of `ops/kitchen_step.py`.
struct Args {
  const float* params[17];  // KitchenParams, field order
  const float *goal, *masks, *joint_lo, *joint_hi, *obj_lo, *obj_hi;
  const int64_t *primary, *secondary;
  const float *ratio, *dh, *base;
  // state in
  const float *qpos, *ee;
  const bool *open, *completed;
  const int* order;
  const bool *grasped, *done;
  const int* steps;
  const float* action;
  // state out and the reward
  float *qpos_out, *ee_out;
  bool *open_out, *completed_out;
  int* order_out;
  bool *grasped_out, *done_out;
  int* steps_out;
  float* reward;
  float act_amp, control_dt, bonus_thresh;
  int B;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp, torch.clamp(min=), torch.clamp(max=): NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }

// torch.sum over a last dim of 3, and a product summed by it
__device__ __forceinline__ float sum3(float x, float y, float z) { return add(add(x, y), z); }
__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return sum3(mul(u[0], v[0]), mul(u[1], v[1]), mul(u[2], v[2]));
}
// torch.linalg.norm over a last dim of 3
__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(sum3(mul(v[0], v[0]), mul(v[1], v[1]), mul(v[2], v[2])));
}
// torch.linalg.cross(u, v), whose kernel contracts each component's first
// product into an FMA
__device__ __forceinline__ void cross3(const float* u, const float* v, float* out) {
  out[0] = fmaf(u[1], v[2], -mul(u[2], v[1]));
  out[1] = fmaf(u[2], v[0], -mul(u[0], v[2]));
  out[2] = fmaf(u[0], v[1], -mul(u[1], v[0]));
}

// qpos entries at indices read from the tables: selected in registers
__device__ __forceinline__ float get(const float (&q)[NQ], int i) {
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < NQ; ++j) r = (j == i) ? q[j] : r;
  return r;
}
__device__ __forceinline__ void set(float (&q)[NQ], int i, float v) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) q[j] = (j == i) ? v : q[j];
}

// `fk.panda_fk`: the fingertip of the arm at joints q[7], the links'
// modified-DH transforms chained left to right, then the fingertip offset
// (theta 0), then the base. T holds the top three rows (the last is 0 0 0 1).
__device__ void panda_fk(const Scene& S, const float* q, float* tip) {
  float T[3][4] = {{1.f, 0.f, 0.f, 0.f}, {0.f, 1.f, 0.f, 0.f}, {0.f, 0.f, 1.f, 0.f}};
#pragma unroll
  for (int i = 0; i < NDH; ++i) {
    const float theta = i < 7 ? q[i] : 0.f;
    const float ct = cosf(theta), st = sinf(theta);
    const float a = S.dh[i][0], ca = S.dh[i][1], sa = S.dh[i][2];
    // `_mdh_transform`'s rows, as it builds them
    const float M[4][4] = {{ct, -st, 0.f, add(0.f, a)},
                           {mul(st, ca), mul(ct, ca), sub(0.f, sa), sub(0.f, S.dh[i][3])},
                           {mul(st, sa), mul(ct, sa), add(0.f, ca), add(0.f, S.dh[i][4])},
                           {0.f, 0.f, 0.f, 1.f}};
    float R[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = mul(T[r][0], M[0][c]);
#pragma unroll
        for (int k = 1; k < 4; ++k) acc = fmaf(T[r][k], M[k][c], acc);
        R[r][c] = acc;
      }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) T[r][c] = R[r][c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) tip[r] = add(T[r][3], S.base[r]);
}

// `_collides`: fingertip behind the cabinet wall or inside the microwave box
__device__ __forceinline__ bool collides(const Scene& S, const float* p) {
  bool in_micro = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) in_micro = in_micro && (p[k] > S.micro_lo[k]) && (p[k] < S.micro_hi[k]);
  return (p[1] > S.wall_y) || in_micro;
}

// `kitchen_handles`, one articulated element t at its joint value theta
__device__ void handle(const Scene& S, int t, float theta, float* h) {
  const float* ax = S.axes[t];
  if (S.rotary[t] > 0.5f) {  // `_rodrigues` of handle0 - pivot about the axis
    float v[3], cr[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = sub(S.handle0[t][k], S.pivots[t][k]);
    const float c = cosf(theta), s = sinf(theta);
    const float dot = dot3(v, ax);
    cross3(ax, v, cr);
    const float one_c = sub(1.f, c);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      h[k] = add(S.pivots[t][k],
                 add(add(mul(v[k], c), mul(cr[k], s)), mul(mul(ax[k], dot), one_c)));
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) h[k] = add(S.handle0[t][k], mul(ax[k], theta));
  }
}

// `_segment_dist`: fingertip p to element t's handle bar centred at c
__device__ float segment_dist(const Scene& S, int t, const float* p, const float* c) {
  float d[3], diff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = sub(p[k], c[k]);
  const float hl = S.bar_halflen[t];
  const float along = clamp(dot3(d, S.bar_dirs[t]), -hl, hl);
#pragma unroll
  for (int k = 0; k < 3; ++k) diff[k] = sub(p[k], add(c[k], mul(S.bar_dirs[t][k], along)));
  return norm3(diff);
}

// `_angular_advance`: the fingertip's signed angle about element t's axis
__device__ float angular_advance(const Scene& S, int t, const float* p_old, const float* p_new) {
  const float* ax = S.axes[t];
  float uo[3], un[3], po[3], pn[3], cr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uo[k] = sub(p_old[k], S.pivots[t][k]);
    un[k] = sub(p_new[k], S.pivots[t][k]);
  }
  const float so = dot3(uo, ax), sn = dot3(un, ax);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    po[k] = sub(uo[k], mul(ax[k], so));
    pn[k] = sub(un[k], mul(ax[k], sn));
  }
  cross3(po, pn, cr);
  return atan2f(dot3(ax, cr), clamp_min(dot3(po, pn), 1e-12f));
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) kitchen_step_kernel(const Args A) {
  __shared__ Scene S;
  {
    const float* const* p = A.params;
    stage(&S.pivots[0][0], p[0], NE * 3);
    stage(&S.axes[0][0], p[1], NE * 3);
    stage(&S.handle0[0][0], p[2], NE * 3);
    stage(&S.bar_dirs[0][0], p[3], NE * 3);
    stage(S.bar_halflen, p[4], NE);
    stage(S.rotary, p[5], NE);
    stage(S.drive_eff, p[6], NE);
    stage(&S.interact_radius, p[7], 1);
    stage(&S.grasp_radius, p[8], 1);
    stage(&S.release_radius, p[9], 1);
    stage(&S.grip_close, p[10], 1);
    stage(&S.grip_open, p[11], 1);
    stage(&S.kettle_gain, p[12], 1);
    stage(&S.kettle_max_speed, p[13], 1);
    stage(&S.wall_y, p[14], 1);
    stage(S.micro_lo, p[15], 3);
    stage(S.micro_hi, p[16], 3);
    stage(S.goal, A.goal, NQ);
    stage(&S.masks[0][0], A.masks, NE * NQ);
    stage(S.joint_lo, A.joint_lo, NJ);
    stage(S.joint_hi, A.joint_hi, NJ);
    stage(S.obj_lo, A.obj_lo, NOBJ);
    stage(S.obj_hi, A.obj_hi, NOBJ);
    for (int i = threadIdx.x; i < NE; i += blockDim.x) {
      S.primary[i] = static_cast<int>(A.primary[i]);
      S.secondary[i] = static_cast<int>(A.secondary[i]);
    }
    stage(S.ratio, A.ratio, NE);
    stage(&S.dh[0][0], A.dh, NDH * 5);
    stage(S.base, A.base, 3);
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= A.B) return;

  float q[NQ], e0[3];
#pragma unroll
  for (int j = 0; j < NQ; ++j) q[j] = A.qpos[b * NQ + j];
#pragma unroll
  for (int k = 0; k < 3; ++k) e0[k] = A.ee[b * 3 + k];

  // robot: velocity-integrated joints, clamped to their limits
  float qc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float a = mul(clamp(A.action[b * NJ + j], -1.f, 1.f), A.act_amp);
    qc[j] = clamp(add(q[j], mul(a, A.control_dt)), S.joint_lo[j], S.joint_hi[j]);
  }
  float ec[3];
  panda_fk(S, qc, ec);
  // arm motion that starts or deepens a penetration is blocked; the
  // fingers always move
  const bool blocked = collides(S, ec) && !collides(S, e0);
  float qr[NJ], en[3], disp[3];
#pragma unroll
  for (int j = 0; j < NJ; ++j) qr[j] = (blocked && j < 7) ? q[j] : qc[j];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    en[k] = blocked ? e0[k] : ec[k];
    disp[k] = sub(en[k], e0[k]);
  }

  // objects: a fingertip hooked on a handle at the step's start drives the
  // joint by drive_eff x its angular (slide: linear) advance; the drive is
  // kept only if the fingertip ends within interact_radius of the handle
  // moved by it
  const float* kettle = &q[KETTLE_Q];  // the kettle's handle, at its body
  float drive[NE], kettle_dist = 0.f;
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int pq = S.primary[t];
    const float theta = get(q, pq);
    float h[3];
    if (t == KETTLE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) h[k] = kettle[k];
    } else {
      handle(S, t, theta, h);
    }
    const bool hooked = segment_dist(S, t, e0, h) < S.interact_radius;
    const float dphi = angular_advance(S, t, e0, en);
    const float dlin = dot3(disp, S.axes[t]);
    const float drive_try =
        mul(mul(S.rotary[t] > 0.5f ? dphi : dlin, S.drive_eff[t]), hooked ? 1.f : 0.f);
    // the handle at the joint clipped to its range: the element's own
    // handle moved (the kettle's stays at its body)
    const float q_try = clamp(add(theta, drive_try), S.obj_lo[pq - NJ], S.obj_hi[pq - NJ]);
    float h_end[3];
    if (t == KETTLE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) h_end[k] = kettle[k];
      kettle_dist = segment_dist(S, t, en, h);
    } else {
      handle(S, t, q_try, h_end);
    }
    const bool keep = segment_dist(S, t, en, h_end) < S.interact_radius;
    drive[t] = mul(drive_try, keep ? 1.f : 0.f);
  }

  float qn[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) qn[j] = j < NJ ? qr[j] : q[j];
  // articulated elements (all but the kettle); a secondary joint follows its
  // primary at a fixed ratio
#pragma unroll
  for (int t = 0; t < NE - 1; ++t) {
    const int p = S.primary[t], s = S.secondary[t];
    set(qn, p, add(get(qn, p), drive[t]));
    if (s != p) set(qn, s, add(get(qn, s), mul(drive[t], S.ratio[t])));
  }

  // kettle: gripper-latched grasp; while held it follows the fingertip's
  // displacement at the slip gain under the speed cap
  const float grip = mul(add(qr[7], qr[8]), 0.5f);
  const bool was_grasped = A.grasped[b];
  const bool engage = !was_grasped && (kettle_dist < S.grasp_radius) && (grip < S.grip_close);
  const bool release =
      was_grasped && ((grip > S.grip_open) || (kettle_dist > S.release_radius));
  const bool grasped = (was_grasped || engage) && !release;
  float kd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) kd[k] = mul(disp[k], S.kettle_gain);
  const float cap =
      clamp_max(__fdiv_rn(S.kettle_max_speed, clamp_min(norm3(kd), 1e-9f)), 1.f);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    qn[KETTLE_Q + k] = add(q[KETTLE_Q + k], mul(grasped ? 1.f : 0.f, mul(kd[k], cap)));
#pragma unroll
  for (int j = NJ; j < NQ; ++j) qn[j] = clamp(qn[j], S.obj_lo[j - NJ], S.obj_hi[j - NJ]);

  // completion and reward
  const int steps = A.steps[b];
  const bool was_done = A.done[b];
  bool any_open = false;
  float reward = 0.f;
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float d = mul(sub(qn[j], S.goal[j]), S.masks[t][j]);
      ss = add(ss, mul(d, d));
    }
    const bool open = A.open[b * NE + t];
    const bool newly = (sqrtf(ss) < A.bonus_thresh) && open;
    const int order = A.order[b * NE + t];
    const bool left = open && !newly;
    any_open = any_open || left;
    reward = add(reward, newly ? 1.f : 0.f);
    A.open_out[b * NE + t] = was_done ? open : left;
    A.completed_out[b * NE + t] = A.completed[b * NE + t] || (newly && !was_done);
    A.order_out[b * NE + t] = (!was_done && newly && order < 0) ? steps + 1 : order;
  }

  // envs that were done keep their state and get no reward
#pragma unroll
  for (int j = 0; j < NQ; ++j) A.qpos_out[b * NQ + j] = was_done ? q[j] : qn[j];
#pragma unroll
  for (int k = 0; k < 3; ++k) A.ee_out[b * 3 + k] = was_done ? e0[k] : en[k];
  A.grasped_out[b] = was_done ? was_grasped : grasped;
  A.done_out[b] = was_done || !any_open;
  A.steps_out[b] = was_done ? steps : steps + 1;
  A.reward[b] = was_done ? 0.f : reward;
}

}  // namespace

extern "C" {

// One control step of B envs on `stream`; returns cudaGetLastError() (0 =
// launched). `params` holds KitchenParams' 17 tensors in field order,
// `tables` the env's 11 tables (goal, task masks, joint lo and hi, object lo
// and hi, primary and secondary joints as int64, the secondary ratios, the
// modified-DH table [8, 5], the base), `state` the 8 KitchenState fields in
// order, `out` the 8 new fields and the reward. Shapes, types and
// contiguity are checked by the wrapper (ops/kitchen_step.py); every load is
// a scalar one, so a tensor's own alignment does.
int beso_kitchen_step(const void* const* params, const void* const* tables,
                      const void* const* state, const void* action, void* const* out,
                      float act_amp, float control_dt, float bonus_thresh, int B,
                      void* stream) {
  Args a;
  for (int i = 0; i < 17; ++i) a.params[i] = static_cast<const float*>(params[i]);
  a.goal = static_cast<const float*>(tables[0]);
  a.masks = static_cast<const float*>(tables[1]);
  a.joint_lo = static_cast<const float*>(tables[2]);
  a.joint_hi = static_cast<const float*>(tables[3]);
  a.obj_lo = static_cast<const float*>(tables[4]);
  a.obj_hi = static_cast<const float*>(tables[5]);
  a.primary = static_cast<const int64_t*>(tables[6]);
  a.secondary = static_cast<const int64_t*>(tables[7]);
  a.ratio = static_cast<const float*>(tables[8]);
  a.dh = static_cast<const float*>(tables[9]);
  a.base = static_cast<const float*>(tables[10]);
  a.qpos = static_cast<const float*>(state[0]);
  a.ee = static_cast<const float*>(state[1]);
  a.open = static_cast<const bool*>(state[2]);
  a.completed = static_cast<const bool*>(state[3]);
  a.order = static_cast<const int*>(state[4]);
  a.grasped = static_cast<const bool*>(state[5]);
  a.done = static_cast<const bool*>(state[6]);
  a.steps = static_cast<const int*>(state[7]);
  a.action = static_cast<const float*>(action);
  a.qpos_out = static_cast<float*>(out[0]);
  a.ee_out = static_cast<float*>(out[1]);
  a.open_out = static_cast<bool*>(out[2]);
  a.completed_out = static_cast<bool*>(out[3]);
  a.order_out = static_cast<int*>(out[4]);
  a.grasped_out = static_cast<bool*>(out[5]);
  a.done_out = static_cast<bool*>(out[6]);
  a.steps_out = static_cast<int*>(out[7]);
  a.reward = static_cast<float*>(out[8]);
  a.act_amp = act_amp;
  a.control_dt = control_dt;
  a.bonus_thresh = bonus_thresh;
  a.B = B;
  const int blocks = (B + kThreads - 1) / kThreads;
  kitchen_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
