// Real-time host bridge: lock-free state exchange + compensated-rate loops
// + motor-command safety clamps.
//
// The PyTorch port's own copy of the JAX package's bridge source (the same
// code; runtime/bridge.py builds it with g++ into build/rt_bridge/). It is
// the host side of the reference's C++ runtime layer:
//  - the free-running compensated-sleep control threads
//    (MainHardware.cpp:85-129: sleep(period - elapsed)),
//  - the 1 kHz UDP receive thread's sensor/command exchange
//    (HardwareA1ROS.cpp:253-386) — here a lock-free seqlock "blackboard"
//    replacing both ROS topics and the racy shared A1CtrlStates struct,
//  - the vendor SDK safety layer PositionLimit/PowerProtect
//    (HardwareA1ROS.cpp:200-202) re-implemented from its documented
//    semantics (joint clamps + power-level torque budget).
//
// The GPU solves the QPs; this bridge is the deterministic low-jitter host
// side that feeds it sensors and ships torque commands, exposed to Python
// through a plain C ABI (ctypes).

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>

namespace {

constexpr int kNumJoints = 12;

// Go1 joint limits (rad) and torque ceilings (N·m per joint class),
// matching the clip tables used by the RL controller
// (Go1RLController.cpp:36-37) and the Unitree power-protect semantics.
constexpr double kPosLower[3] = {-0.9425, -0.4817, -2.6285};
constexpr double kPosUpper[3] = {0.9425, 2.7855, -0.9320};
constexpr double kTauMax[3] = {23.7, 23.7, 35.55};

struct SensorFrame {
  double quat[4];       // w, x, y, z
  double acc[3];
  double gyro[3];
  double joint_pos[kNumJoints];
  double joint_vel[kNumJoints];
  double foot_force[4];
  int64_t tick;
};

struct CommandFrame {
  double tau[kNumJoints];
  double q[kNumJoints];
  double kp[kNumJoints];
  double kd[kNumJoints];
  int64_t tick;
};

// Single-writer seqlock slot: readers retry on odd/changed sequence.
template <typename T>
struct Seqlock {
  std::atomic<uint64_t> seq{0};
  T data{};

  void write(const T& v) {
    const uint64_t s = seq.load(std::memory_order_relaxed);
    seq.store(s + 1, std::memory_order_release);  // odd: write in progress
    std::atomic_thread_fence(std::memory_order_release);
    data = v;
    std::atomic_thread_fence(std::memory_order_release);
    seq.store(s + 2, std::memory_order_release);
  }

  void read(T* out) const {
    for (;;) {
      const uint64_t s1 = seq.load(std::memory_order_acquire);
      if (s1 & 1) continue;
      std::atomic_thread_fence(std::memory_order_acquire);
      T tmp = data;
      std::atomic_thread_fence(std::memory_order_acquire);
      const uint64_t s2 = seq.load(std::memory_order_acquire);
      if (s1 == s2) {
        *out = tmp;
        return;
      }
    }
  }
};

constexpr int kFootFilterWindow = 5;  // FOOT_FILTER_WINDOW_SIZE,
                                      // HardwareA1ROS.h:42

// Unitree SDK wire order (FR, FL, RR, RL) <-> controller order
// (FL, FR, RL, RR): the involution swap tables the reference applies on
// both the receive unpack and the command pack
// (HardwareA1ROS.cpp:78-79, 293-298, send_cmd:190).
constexpr int kSwapJoint[kNumJoints] = {3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8};
constexpr int kSwapFoot[4] = {1, 0, 3, 2};

struct Bridge {
  Seqlock<SensorFrame> sensors;
  Seqlock<CommandFrame> commands;
  std::atomic<int64_t> sensor_ticks{0};
  std::atomic<int64_t> command_ticks{0};
  std::atomic<bool> running{false};
  int power_level = 5;  // 1..10, scales the torque budget like PowerProtect
  // 5-sample foot-force ring filter on the receive path
  // (HardwareA1ROS.cpp:300-312). The divisor is ALWAYS the full window —
  // the reference quirk: the first pushes read low until the ring fills.
  // window 0 = raw passthrough (the Gazebo adapter does not filter).
  int foot_filter_window = 0;
  double foot_ring[4][kFootFilterWindow] = {};
  double foot_ring_sum[4] = {};
  int foot_ring_idx[4] = {};
  // true = sensor frames arrive (and command frames leave) in the SDK
  // wire order FR, FL, RR, RL and the bridge remaps to/from controller
  // order FL, FR, RL, RR. False (sim feeders) = already controller order.
  bool sdk_leg_order = false;
};

// Compensated-sleep rate keeper: period minus elapsed work time, never
// negative (MainHardware.cpp:85-86, 128-129).
struct RateKeeper {
  std::chrono::steady_clock::time_point next;
  std::chrono::nanoseconds period;
  int64_t overruns = 0;

  explicit RateKeeper(double period_s)
      : next(std::chrono::steady_clock::now()),
        period(static_cast<int64_t>(period_s * 1e9)) {}

  void wait() {
    next += period;
    const auto now = std::chrono::steady_clock::now();
    if (now < next) {
      std::this_thread::sleep_until(next);
    } else {
      ++overruns;
      next = now;  // fell behind: re-anchor instead of bursting
    }
  }
};

}  // namespace

extern "C" {

void* rt_bridge_create(int power_level) {
  auto* b = new Bridge();
  b->power_level = power_level < 1 ? 1 : (power_level > 10 ? 10 : power_level);
  b->running.store(true);
  return b;
}

void rt_bridge_destroy(void* h) {
  auto* b = static_cast<Bridge*>(h);
  b->running.store(false);
  delete b;
}

// --- sensor side (the 1 kHz receive thread's role) -----------------------

void rt_bridge_push_sensors(void* h, const double* quat, const double* acc,
                            const double* gyro, const double* joint_pos,
                            const double* joint_vel,
                            const double* foot_force) {
  auto* b = static_cast<Bridge*>(h);
  SensorFrame f;
  std::memcpy(f.quat, quat, sizeof(f.quat));
  std::memcpy(f.acc, acc, sizeof(f.acc));
  std::memcpy(f.gyro, gyro, sizeof(f.gyro));
  double jp[kNumJoints], jv[kNumJoints], ff[4];
  if (b->sdk_leg_order) {
    // SDK wire order -> controller order (HardwareA1ROS.cpp:293-298);
    // the foot filter below then runs on the controller-ordered stream,
    // exactly like the reference indexes its filter rings by the
    // controller leg while reading state.footForce[swap_i]
    for (int i = 0; i < kNumJoints; ++i) {
      jp[i] = joint_pos[kSwapJoint[i]];
      jv[i] = joint_vel[kSwapJoint[i]];
    }
    for (int i = 0; i < 4; ++i) ff[i] = foot_force[kSwapFoot[i]];
    joint_pos = jp;
    joint_vel = jv;
    foot_force = ff;
  }
  std::memcpy(f.joint_pos, joint_pos, sizeof(f.joint_pos));
  std::memcpy(f.joint_vel, joint_vel, sizeof(f.joint_vel));
  if (b->foot_filter_window > 0) {
    // single-writer ring (push_sensors is the one receive thread)
    const int w = b->foot_filter_window;
    for (int i = 0; i < 4; ++i) {
      b->foot_ring_sum[i] -= b->foot_ring[i][b->foot_ring_idx[i]];
      b->foot_ring[i][b->foot_ring_idx[i]] = foot_force[i];
      b->foot_ring_sum[i] += foot_force[i];
      b->foot_ring_idx[i] = (b->foot_ring_idx[i] + 1) % w;
      f.foot_force[i] = b->foot_ring_sum[i] / static_cast<double>(w);
    }
  } else {
    std::memcpy(f.foot_force, foot_force, sizeof(f.foot_force));
  }
  f.tick = b->sensor_ticks.fetch_add(1) + 1;
  b->sensors.write(f);
}

// window in [0, kFootFilterWindow]; 0 disables (raw passthrough).
void rt_bridge_set_foot_filter(void* h, int window) {
  auto* b = static_cast<Bridge*>(h);
  if (window < 0) window = 0;
  if (window > kFootFilterWindow) window = kFootFilterWindow;
  b->foot_filter_window = window;
  for (int i = 0; i < 4; ++i) {
    b->foot_ring_sum[i] = 0.0;
    b->foot_ring_idx[i] = 0;
    for (int j = 0; j < kFootFilterWindow; ++j) b->foot_ring[i][j] = 0.0;
  }
}

int64_t rt_bridge_read_sensors(void* h, double* out /* 4+3+3+12+12+4 */) {
  auto* b = static_cast<Bridge*>(h);
  SensorFrame f;
  b->sensors.read(&f);
  std::memcpy(out, f.quat, sizeof(f.quat));
  std::memcpy(out + 4, f.acc, sizeof(f.acc));
  std::memcpy(out + 7, f.gyro, sizeof(f.gyro));
  std::memcpy(out + 10, f.joint_pos, sizeof(f.joint_pos));
  std::memcpy(out + 22, f.joint_vel, sizeof(f.joint_vel));
  std::memcpy(out + 34, f.foot_force, sizeof(f.foot_force));
  return f.tick;
}

// --- command side with safety clamps -------------------------------------

// PositionLimit + PowerProtect semantics (HardwareA1ROS.cpp:200-202):
// clamp q targets into joint limits; scale the torque ceiling by
// power_level/10; zero torques that remain out of range (NaN-safe).
void rt_bridge_push_command(void* h, const double* tau, const double* q,
                            const double* kp, const double* kd) {
  auto* b = static_cast<Bridge*>(h);
  CommandFrame c;
  const double budget = static_cast<double>(b->power_level) / 10.0;
  for (int i = 0; i < kNumJoints; ++i) {
    const int j = i % 3;
    double t = tau[i];
    if (std::isnan(t)) t = 0.0;
    const double tmax = kTauMax[j] * budget;
    c.tau[i] = t > tmax ? tmax : (t < -tmax ? -tmax : t);
    double qq = q[i];
    if (std::isnan(qq)) qq = 0.0;
    c.q[i] = qq > kPosUpper[j] ? kPosUpper[j]
                               : (qq < kPosLower[j] ? kPosLower[j] : qq);
    c.kp[i] = kp[i];
    c.kd[i] = kd[i];
  }
  c.tick = b->command_ticks.fetch_add(1) + 1;
  b->commands.write(c);
}

int64_t rt_bridge_read_command(void* h, double* out /* 12*4 */) {
  auto* b = static_cast<Bridge*>(h);
  CommandFrame c;
  b->commands.read(&c);
  if (b->sdk_leg_order) {
    // controller order -> SDK wire order for the UDP send path
    // (HardwareA1ROS.cpp:190: cmd.motorCmd[i].tau = torques(swap_i))
    for (int i = 0; i < kNumJoints; ++i) {
      const int s = kSwapJoint[i];
      out[i] = c.tau[s];
      out[12 + i] = c.q[s];
      out[24 + i] = c.kp[s];
      out[36 + i] = c.kd[s];
    }
    return c.tick;
  }
  std::memcpy(out, c.tau, sizeof(c.tau));
  std::memcpy(out + 12, c.q, sizeof(c.q));
  std::memcpy(out + 24, c.kp, sizeof(c.kp));
  std::memcpy(out + 36, c.kd, sizeof(c.kd));
  return c.tick;
}

// enable = 1: sensor frames are pushed in SDK wire order (FR, FL, RR, RL)
// and command frames are read back in SDK wire order; the bridge's
// internal blackboard (and everything the controller sees) stays in
// controller order (FL, FR, RL, RR). Matches HardwareA1ROS.cpp:78-79.
void rt_bridge_set_leg_order(void* h, int sdk_order) {
  static_cast<Bridge*>(h)->sdk_leg_order = sdk_order != 0;
}

// --- rate keeper ----------------------------------------------------------

void* rt_rate_create(double period_s) { return new RateKeeper(period_s); }

void rt_rate_wait(void* h) { static_cast<RateKeeper*>(h)->wait(); }

int64_t rt_rate_overruns(void* h) {
  return static_cast<RateKeeper*>(h)->overruns;
}

void rt_rate_destroy(void* h) { delete static_cast<RateKeeper*>(h); }

// --- timing self-test: run a compensated loop, return achieved jitter ----

double rt_bridge_timing_test(double period_s, int iters) {
  RateKeeper rk(period_s);
  auto last = std::chrono::steady_clock::now();
  double worst = 0.0;
  for (int i = 0; i < iters; ++i) {
    rk.wait();
    const auto now = std::chrono::steady_clock::now();
    const double dt =
        std::chrono::duration<double>(now - last).count();
    last = now;
    const double err = std::fabs(dt - period_s);
    if (i > 2 && err > worst) worst = err;
  }
  return worst;
}

}  // extern "C"
