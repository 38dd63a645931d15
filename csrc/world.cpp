// Native ground-truth world simulator (C++), role-equivalent to the
// reference's C++ env layer (src/PointMassEnv.cpp + MuJoCo 2.00): the
// host-side "real world" the JAX controller is closed against.
//
// Physics is the MuJoCo-equivalent decoupled per-axis linear ODE
//     (m + armature) * qdd = gear * clamp(u, +-ctrl_range) - damping * qd
// integrated with RK4 at `timestep` (see mppi_gpu_tpu/envs/params.py for the
// derivation from the reference XMLs). Exposed as a plain C API consumed via
// ctypes (mppi_gpu_tpu/envs/native.py). The pure-JAX world
// (envs/point_mass_world.py) implements identical semantics; the two are
// cross-checked in tests/test_envs.py.
//
// Build:  g++ -O2 -shared -fPIC -o libmppiworld.so world.cpp   (or `make`)

#include <cmath>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kMaxAxes = 8;

struct Params {
  int n_axes;
  float mass;
  float armature;
  float damping;
  float gear;
  float ctrl_range;
  float joint_range;
  float timestep;
  float control_period;
  float sim_end;
};

struct World {
  Params p;
  float q[kMaxAxes];
  float qd[kMaxAxes];
  float time;
  int steps_per_control;
};

inline float accel(const Params& p, float qd, float u) {
  return (p.gear * u - p.damping * qd) / (p.mass + p.armature);
}

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One RK4 step of the decoupled linear system, all axes.
void physics_step(World* w, const float* u_in) {
  const Params& p = w->p;
  const float h = p.timestep;
  for (int i = 0; i < p.n_axes; ++i) {
    const float u = clampf(u_in[i], -p.ctrl_range, p.ctrl_range);
    const float q = w->q[i];
    const float qd = w->qd[i];

    const float k1q = qd, k1v = accel(p, qd, u);
    const float k2q = qd + 0.5f * h * k1v, k2v = accel(p, qd + 0.5f * h * k1v, u);
    const float k3q = qd + 0.5f * h * k2v, k3v = accel(p, qd + 0.5f * h * k2v, u);
    const float k4q = qd + h * k3v, k4v = accel(p, qd + h * k3v, u);

    float q_new = q + (h / 6.0f) * (k1q + 2.0f * k2q + 2.0f * k3q + k4q);
    float qd_new = qd + (h / 6.0f) * (k1v + 2.0f * k2v + 2.0f * k3v + k4v);

    // hard joint-limit clamp with velocity zeroing at the stop
    if (q_new > p.joint_range || q_new < -p.joint_range) {
      q_new = clampf(q_new, -p.joint_range, p.joint_range);
      qd_new = 0.0f;
    }
    w->q[i] = q_new;
    w->qd[i] = qd_new;
  }
  w->time += h;
}

}  // namespace

extern "C" {

World* mppi_world_create(int n_axes, float mass, float armature, float damping,
                         float gear, float ctrl_range, float joint_range,
                         float timestep, float control_period, float sim_end) {
  if (n_axes < 1 || n_axes > kMaxAxes) return nullptr;
  World* w = static_cast<World*>(std::calloc(1, sizeof(World)));
  if (!w) return nullptr;
  w->p = Params{n_axes, mass,     armature,       damping, gear,
                ctrl_range,       joint_range,    timestep,
                control_period,   sim_end};
  w->steps_per_control =
      static_cast<int>(std::ceil(control_period / timestep - 1e-9));
  // warm-up state: origin, at rest, time = one physics step
  // (matches the reference's constructor mj_step, PointMassEnv.cpp:94)
  w->time = timestep;
  return w;
}

void mppi_world_destroy(World* w) { std::free(w); }

void mppi_world_reset(World* w) {
  std::memset(w->q, 0, sizeof(w->q));
  std::memset(w->qd, 0, sizeof(w->qd));
  w->time = w->p.timestep;
}

// One control cycle: hold u for `control_period` of sim time. Returns 1 when
// the episode is over (checked before stepping, like PointMassEnv::simulate).
int mppi_world_simulate(World* w, const float* u) {
  if (w->time >= w->p.sim_end) return 1;
  for (int s = 0; s < w->steps_per_control; ++s) physics_step(w, u);
  return 0;
}

// Single physics step (reference PointMassEnv::step).
void mppi_world_step(World* w, const float* u) { physics_step(w, u); }

void mppi_world_get_x(World* w, float* x) {
  for (int i = 0; i < w->p.n_axes; ++i) x[i] = w->q[i];
  for (int i = 0; i < w->p.n_axes; ++i) x[w->p.n_axes + i] = w->qd[i];
}

float mppi_world_time(World* w) { return w->time; }

// Restore world state from a checkpoint: x = [q(0..a-1), qd(0..a-1)].
void mppi_world_set_state(World* w, const float* x, float time) {
  for (int i = 0; i < w->p.n_axes; ++i) w->q[i] = x[i];
  for (int i = 0; i < w->p.n_axes; ++i) w->qd[i] = x[w->p.n_axes + i];
  w->time = time;
}

int mppi_world_steps_per_control(World* w) { return w->steps_per_control; }

// Open-loop rollout for the model-mismatch harness: apply u_seq[(n, a)] one
// control cycle each, recording [x0; x1; ...; xn] into traj[(n+1, 2a)].
void mppi_world_rollout(World* w, const float* u_seq, int n, float* traj) {
  const int d = 2 * w->p.n_axes;
  mppi_world_get_x(w, traj);
  for (int t = 0; t < n; ++t) {
    mppi_world_simulate(w, u_seq + t * w->p.n_axes);
    mppi_world_get_x(w, traj + (t + 1) * d);
  }
}

// ---------------------------------------------------------------------------
// Pendulum world (second model family): same ODE as the JAX world in
// mppi_gpu_tpu/envs/pendulum_world.py — theta measured from upright,
//   thdd = (g/l)*sin(th) + u/(m*l^2) - b*thd,  u clamped to +-max_torque —
// RK4 at `timestep`.

struct Pendulum {
  float mass, length, gravity, damping, max_torque;
  float timestep, control_period, sim_end, init_theta;
  float th, thd, time;
  int steps_per_control;
};

static inline float pend_accel(const Pendulum* p, float th, float thd, float u) {
  return (p->gravity / p->length) * std::sin(th) +
         u / (p->mass * p->length * p->length) - p->damping * thd;
}

static void pend_physics_step(Pendulum* p, float u_in) {
  const float h = p->timestep;
  const float u = clampf(u_in, -p->max_torque, p->max_torque);
  const float th = p->th, thd = p->thd;
  const float k1t = thd, k1v = pend_accel(p, th, thd, u);
  const float k2t = thd + 0.5f * h * k1v,
              k2v = pend_accel(p, th + 0.5f * h * k1t, thd + 0.5f * h * k1v, u);
  const float k3t = thd + 0.5f * h * k2v,
              k3v = pend_accel(p, th + 0.5f * h * k2t, thd + 0.5f * h * k2v, u);
  const float k4t = thd + h * k3v,
              k4v = pend_accel(p, th + h * k3t, thd + h * k3v, u);
  p->th += (h / 6.0f) * (k1t + 2.0f * k2t + 2.0f * k3t + k4t);
  p->thd += (h / 6.0f) * (k1v + 2.0f * k2v + 2.0f * k3v + k4v);
  p->time += h;
}

extern "C" {

Pendulum* mppi_pendulum_create(float mass, float length, float gravity,
                               float damping, float max_torque, float timestep,
                               float control_period, float sim_end,
                               float init_theta) {
  Pendulum* p = static_cast<Pendulum*>(std::calloc(1, sizeof(Pendulum)));
  if (!p) return nullptr;
  p->mass = mass;
  p->length = length;
  p->gravity = gravity;
  p->damping = damping;
  p->max_torque = max_torque;
  p->timestep = timestep;
  p->control_period = control_period;
  p->sim_end = sim_end;
  p->init_theta = init_theta;
  p->steps_per_control =
      static_cast<int>(std::ceil(control_period / timestep - 1e-9));
  p->th = init_theta;
  p->thd = 0.0f;
  p->time = timestep;
  return p;
}

void mppi_pendulum_destroy(Pendulum* p) { std::free(p); }

void mppi_pendulum_reset(Pendulum* p) {
  p->th = p->init_theta;
  p->thd = 0.0f;
  p->time = p->timestep;
}

int mppi_pendulum_simulate(Pendulum* p, const float* u) {
  if (p->time >= p->sim_end) return 1;
  for (int s = 0; s < p->steps_per_control; ++s) pend_physics_step(p, u[0]);
  return 0;
}

void mppi_pendulum_step(Pendulum* p, const float* u) {
  pend_physics_step(p, u[0]);
}

void mppi_pendulum_get_x(Pendulum* p, float* x) {
  x[0] = p->th;
  x[1] = p->thd;
}

float mppi_pendulum_time(Pendulum* p) { return p->time; }

void mppi_pendulum_set_state(Pendulum* p, const float* x, float time) {
  p->th = x[0];
  p->thd = x[1];
  p->time = time;
}

}  // extern "C" (pendulum fns)

// ---------------------------------------------------------------------------
// Cart-pole world (third model family): same coupled ODE as the JAX world in
// mppi_gpu_tpu/envs/cartpole_world.py — theta from upright,
//   a    = (u + mp*l*thd^2*sin th) / (mc + mp)
//   thdd = (g*sin th - cos th * a) / (l*(4/3 - mp*cos^2 th/(mc+mp)))
//   pdd  = a - mp*l*thdd*cos th / (mc + mp)
// RK4 at `timestep`, cart clamped at +-track_limit with velocity zeroing.

struct CartPole {
  float cart_mass, pole_mass, pole_length, gravity, max_force, track_limit;
  float timestep, control_period, sim_end, init_theta;
  float p, th, pd, thd, time;
  int steps_per_control;
};

static void cp_accels(const CartPole* c, float th, float thd, float u,
                      float* pdd, float* thdd) {
  const float total = c->cart_mass + c->pole_mass;
  const float s = std::sin(th), co = std::cos(th);
  const float a = (u + c->pole_mass * c->pole_length * thd * thd * s) / total;
  *thdd = (c->gravity * s - co * a) /
          (c->pole_length * (4.0f / 3.0f - c->pole_mass * co * co / total));
  *pdd = a - c->pole_mass * c->pole_length * (*thdd) * co / total;
}

static void cp_physics_step(CartPole* c, float u_in) {
  const float h = c->timestep;
  const float u = clampf(u_in, -c->max_force, c->max_force);
  float y[4] = {c->p, c->th, c->pd, c->thd};
  float k[4][4];
  for (int stage = 0; stage < 4; ++stage) {
    const float f = (stage == 0) ? 0.0f : (stage == 3 ? h : 0.5f * h);
    float ys[4];
    for (int i = 0; i < 4; ++i)
      ys[i] = y[i] + (stage == 0 ? 0.0f : f * k[stage - 1][i]);
    float pdd, thdd;
    cp_accels(c, ys[1], ys[3], u, &pdd, &thdd);
    k[stage][0] = ys[2];
    k[stage][1] = ys[3];
    k[stage][2] = pdd;
    k[stage][3] = thdd;
  }
  for (int i = 0; i < 4; ++i)
    y[i] += (h / 6.0f) * (k[0][i] + 2.0f * k[1][i] + 2.0f * k[2][i] + k[3][i]);
  // hard track limit: clamp cart, zero its velocity at the stop
  if (y[0] > c->track_limit || y[0] < -c->track_limit) {
    y[0] = clampf(y[0], -c->track_limit, c->track_limit);
    y[2] = 0.0f;
  }
  c->p = y[0];
  c->th = y[1];
  c->pd = y[2];
  c->thd = y[3];
  c->time += h;
}

extern "C" {

CartPole* mppi_cartpole_create(float cart_mass, float pole_mass,
                               float pole_length, float gravity,
                               float max_force, float track_limit,
                               float timestep, float control_period,
                               float sim_end, float init_theta) {
  CartPole* c = static_cast<CartPole*>(std::calloc(1, sizeof(CartPole)));
  if (!c) return nullptr;
  c->cart_mass = cart_mass;
  c->pole_mass = pole_mass;
  c->pole_length = pole_length;
  c->gravity = gravity;
  c->max_force = max_force;
  c->track_limit = track_limit;
  c->timestep = timestep;
  c->control_period = control_period;
  c->sim_end = sim_end;
  c->init_theta = init_theta;
  c->steps_per_control =
      static_cast<int>(std::ceil(control_period / timestep - 1e-9));
  c->th = init_theta;
  c->time = timestep;
  return c;
}

void mppi_cartpole_destroy(CartPole* c) { std::free(c); }

void mppi_cartpole_reset(CartPole* c) {
  c->p = c->pd = c->thd = 0.0f;
  c->th = c->init_theta;
  c->time = c->timestep;
}

int mppi_cartpole_simulate(CartPole* c, const float* u) {
  if (c->time >= c->sim_end) return 1;
  for (int s = 0; s < c->steps_per_control; ++s) cp_physics_step(c, u[0]);
  return 0;
}

void mppi_cartpole_step(CartPole* c, const float* u) {
  cp_physics_step(c, u[0]);
}

void mppi_cartpole_get_x(CartPole* c, float* x) {
  x[0] = c->p;
  x[1] = c->th;
  x[2] = c->pd;
  x[3] = c->thd;
}

float mppi_cartpole_time(CartPole* c) { return c->time; }

void mppi_cartpole_set_state(CartPole* c, const float* x, float time) {
  c->p = x[0];
  c->th = x[1];
  c->pd = x[2];
  c->thd = x[3];
  c->time = time;
}

}  // extern "C" (cartpole fns)

// ---------------------------------------------------------------------------
// Planar-quadrotor world (fourth model family): same ODE as the JAX world in
// mppi_gpu_tpu/envs/quadrotor_world.py — state [px, pz, th, vx, vz, om],
// action u = [F, D] mixer command, mixed to per-rotor thrusts
// f_{l,r} = (F +- D)/2 each clamped to [0, max_thrust],
//   xdd  = (f1 + f2) * sin(th) / m
//   zdd  = (f1 + f2) * cos(th) / m - g
//   thdd = arm * (f1 - f2) / I
// RK4 at `timestep`.

struct Quadrotor {
  float mass, inertia, arm, gravity, max_thrust;
  float timestep, control_period, sim_end, init_x, init_z;
  float s[6];  // px, pz, th, vx, vz, om
  float time;
  int steps_per_control;
};

static void quad_derivs(const Quadrotor* q, const float* y, float u1, float u2,
                        float* dy) {
  const float f_tot = u1 + u2;
  dy[0] = y[3];
  dy[1] = y[4];
  dy[2] = y[5];
  dy[3] = f_tot * std::sin(y[2]) / q->mass;
  dy[4] = f_tot * std::cos(y[2]) / q->mass - q->gravity;
  dy[5] = q->arm * (u1 - u2) / q->inertia;
}

static void quad_physics_step(Quadrotor* q, const float* u_in) {
  const float h = q->timestep;
  // mixer: (F, D) -> per-rotor thrusts, clamped to the envelope
  const float u1 = clampf(0.5f * (u_in[0] + u_in[1]), 0.0f, q->max_thrust);
  const float u2 = clampf(0.5f * (u_in[0] - u_in[1]), 0.0f, q->max_thrust);
  float k1[6], k2[6], k3[6], k4[6], ys[6];
  quad_derivs(q, q->s, u1, u2, k1);
  for (int i = 0; i < 6; ++i) ys[i] = q->s[i] + 0.5f * h * k1[i];
  quad_derivs(q, ys, u1, u2, k2);
  for (int i = 0; i < 6; ++i) ys[i] = q->s[i] + 0.5f * h * k2[i];
  quad_derivs(q, ys, u1, u2, k3);
  for (int i = 0; i < 6; ++i) ys[i] = q->s[i] + h * k3[i];
  quad_derivs(q, ys, u1, u2, k4);
  for (int i = 0; i < 6; ++i)
    q->s[i] += (h / 6.0f) * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  q->time += h;
}

extern "C" {

Quadrotor* mppi_quadrotor_create(float mass, float inertia, float arm,
                                 float gravity, float max_thrust,
                                 float timestep, float control_period,
                                 float sim_end, float init_x, float init_z) {
  Quadrotor* q = static_cast<Quadrotor*>(std::calloc(1, sizeof(Quadrotor)));
  if (!q) return nullptr;
  q->mass = mass;
  q->inertia = inertia;
  q->arm = arm;
  q->gravity = gravity;
  q->max_thrust = max_thrust;
  q->timestep = timestep;
  q->control_period = control_period;
  q->sim_end = sim_end;
  q->init_x = init_x;
  q->init_z = init_z;
  q->steps_per_control =
      static_cast<int>(std::ceil(control_period / timestep - 1e-9));
  q->s[0] = init_x;
  q->s[1] = init_z;
  q->time = timestep;
  return q;
}

void mppi_quadrotor_destroy(Quadrotor* q) { std::free(q); }

void mppi_quadrotor_reset(Quadrotor* q) {
  std::memset(q->s, 0, sizeof(q->s));
  q->s[0] = q->init_x;
  q->s[1] = q->init_z;
  q->time = q->timestep;
}

int mppi_quadrotor_simulate(Quadrotor* q, const float* u) {
  if (q->time >= q->sim_end) return 1;
  for (int s = 0; s < q->steps_per_control; ++s) quad_physics_step(q, u);
  return 0;
}

void mppi_quadrotor_step(Quadrotor* q, const float* u) {
  quad_physics_step(q, u);
}

void mppi_quadrotor_get_x(Quadrotor* q, float* x) {
  for (int i = 0; i < 6; ++i) x[i] = q->s[i];
}

float mppi_quadrotor_time(Quadrotor* q) { return q->time; }

void mppi_quadrotor_set_state(Quadrotor* q, const float* x, float time) {
  for (int i = 0; i < 6; ++i) q->s[i] = x[i];
  q->time = time;
}

}  // extern "C" (quadrotor fns)

// ---------------------------------------------------------------------------
// 3-D quadrotor world (fifth model family): same rigid-body ODE as the JAX
// world in mppi_gpu_tpu/envs/quadrotor3d_world.py — state
// [p(3), quat(4: w,x,y,z), v(3), body omega(3)], action u = [F, tx, ty, tz]
// mixer command inverted to four per-rotor thrusts ("+" configuration,
// arm r, yaw drag kappa), each clamped to [0, max_thrust], achieved wrench
// reconstituted. RK4 at `timestep`, quaternion normalized per step.

struct Quadrotor3D {
  float mass, jx, jy, jz, arm, kappa, gravity, max_thrust;
  float timestep, control_period, sim_end;
  float init_p[3];
  float s[13];
  float time;
  int steps_per_control;
};

static void quad3d_derivs(const Quadrotor3D* q, const float* y,
                          const float* wrench, float* dy) {
  const float qw = y[3], qx = y[4], qy = y[5], qz = y[6];
  const float wx = y[10], wy = y[11], wz = y[12];
  const float fm = wrench[0] / q->mass;
  dy[0] = y[7];
  dy[1] = y[8];
  dy[2] = y[9];
  dy[3] = -0.5f * (qx * wx + qy * wy + qz * wz);
  dy[4] = 0.5f * (qw * wx + qy * wz - qz * wy);
  dy[5] = 0.5f * (qw * wy + qz * wx - qx * wz);
  dy[6] = 0.5f * (qw * wz + qx * wy - qy * wx);
  dy[7] = 2.0f * (qx * qz + qw * qy) * fm;
  dy[8] = 2.0f * (qy * qz - qw * qx) * fm;
  dy[9] = (1.0f - 2.0f * (qx * qx + qy * qy)) * fm - q->gravity;
  dy[10] = (wrench[1] - (q->jz - q->jy) * wy * wz) / q->jx;
  dy[11] = (wrench[2] - (q->jx - q->jz) * wz * wx) / q->jy;
  dy[12] = (wrench[3] - (q->jy - q->jx) * wx * wy) / q->jz;
}

static void quad3d_physics_step(Quadrotor3D* q, const float* u) {
  const float h = q->timestep;
  // mixer: [F, tx, ty, tz] -> rotor thrusts (f1 +x CCW, f2 +y CW,
  // f3 -x CCW, f4 -y CW), clamped; reconstitute the achieved wrench
  const float qf = 0.25f * u[0];
  const float gx = u[1] / (2.0f * q->arm);
  const float gy = u[2] / (2.0f * q->arm);
  const float gz = u[3] / (4.0f * q->kappa);
  const float f1 = clampf(qf - gy + gz, 0.0f, q->max_thrust);
  const float f2 = clampf(qf + gx - gz, 0.0f, q->max_thrust);
  const float f3 = clampf(qf + gy + gz, 0.0f, q->max_thrust);
  const float f4 = clampf(qf - gx - gz, 0.0f, q->max_thrust);
  const float wrench[4] = {f1 + f2 + f3 + f4, q->arm * (f2 - f4),
                           q->arm * (f3 - f1),
                           q->kappa * (f1 - f2 + f3 - f4)};
  float k1[13], k2[13], k3[13], k4[13], ys[13];
  quad3d_derivs(q, q->s, wrench, k1);
  for (int i = 0; i < 13; ++i) ys[i] = q->s[i] + 0.5f * h * k1[i];
  quad3d_derivs(q, ys, wrench, k2);
  for (int i = 0; i < 13; ++i) ys[i] = q->s[i] + 0.5f * h * k2[i];
  quad3d_derivs(q, ys, wrench, k3);
  for (int i = 0; i < 13; ++i) ys[i] = q->s[i] + h * k3[i];
  quad3d_derivs(q, ys, wrench, k4);
  for (int i = 0; i < 13; ++i)
    q->s[i] += (h / 6.0f) * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  const float n2 = q->s[3] * q->s[3] + q->s[4] * q->s[4] +
                   q->s[5] * q->s[5] + q->s[6] * q->s[6];
  const float inv = 1.0f / std::sqrt(n2);
  for (int i = 3; i < 7; ++i) q->s[i] *= inv;
  q->time += h;
}

extern "C" {

void mppi_quadrotor3d_reset(Quadrotor3D* q);

Quadrotor3D* mppi_quadrotor3d_create(float mass, float jx, float jy, float jz,
                                     float arm, float kappa, float gravity,
                                     float max_thrust, float timestep,
                                     float control_period, float sim_end,
                                     float init_px, float init_py,
                                     float init_pz) {
  Quadrotor3D* q = static_cast<Quadrotor3D*>(std::calloc(1, sizeof(Quadrotor3D)));
  if (!q) return nullptr;
  q->mass = mass;
  q->jx = jx;
  q->jy = jy;
  q->jz = jz;
  q->arm = arm;
  q->kappa = kappa;
  q->gravity = gravity;
  q->max_thrust = max_thrust;
  q->timestep = timestep;
  q->control_period = control_period;
  q->sim_end = sim_end;
  q->init_p[0] = init_px;
  q->init_p[1] = init_py;
  q->init_p[2] = init_pz;
  q->steps_per_control =
      static_cast<int>(std::ceil(control_period / timestep - 1e-9));
  mppi_quadrotor3d_reset(q);
  return q;
}

void mppi_quadrotor3d_destroy(Quadrotor3D* q) { std::free(q); }

void mppi_quadrotor3d_reset(Quadrotor3D* q) {
  std::memset(q->s, 0, sizeof(q->s));
  q->s[0] = q->init_p[0];
  q->s[1] = q->init_p[1];
  q->s[2] = q->init_p[2];
  q->s[3] = 1.0f;  // identity quaternion
  q->time = q->timestep;
}

int mppi_quadrotor3d_simulate(Quadrotor3D* q, const float* u) {
  if (q->time >= q->sim_end) return 1;
  for (int s = 0; s < q->steps_per_control; ++s) quad3d_physics_step(q, u);
  return 0;
}

void mppi_quadrotor3d_step(Quadrotor3D* q, const float* u) {
  quad3d_physics_step(q, u);
}

void mppi_quadrotor3d_get_x(Quadrotor3D* q, float* x) {
  for (int i = 0; i < 13; ++i) x[i] = q->s[i];
}

float mppi_quadrotor3d_time(Quadrotor3D* q) { return q->time; }

void mppi_quadrotor3d_set_state(Quadrotor3D* q, const float* x, float time) {
  for (int i = 0; i < 13; ++i) q->s[i] = x[i];
  q->time = time;
}

}  // extern "C" (quadrotor3d fns)

}  // extern "C"
