"""ctypes wrapper for the C++ real-time host bridge.

The port's copy of the JAX package's ``runtime/bridge.py``. The native
library (``runtime/cpp/rt_bridge.cpp``, the port's own copy of the source)
provides the deterministic host side of the controller: a seqlock sensor /
command blackboard (replacing the reference's racy shared A1CtrlStates +
ROS topics), compensated-sleep rate keepers (MainHardware.cpp:85-129) and
the SDK-equivalent safety clamps (HardwareA1ROS.cpp:200-202).

The library is built at first use with ``g++`` into ``build/rt_bridge/`` at
the repository root, named by a hash of the source and the flags (as
``ops/_build.py`` names the CUDA kernels), so an edited source is rebuilt
and an unchanged one reused.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cpp" / "rt_bridge.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rt_bridge"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None
_load_lock = threading.Lock()


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librt_bridge-{digest.hexdigest()[:12]}.so"


def build():
    """Compile the bridge unless a current library exists; returns its
    path. Raises if the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the real-time "
                           "bridge")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building the real-time bridge failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.rt_bridge_create.restype = ctypes.c_void_p
        lib.rt_bridge_create.argtypes = [ctypes.c_int]
        lib.rt_bridge_destroy.argtypes = [ctypes.c_void_p]
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.rt_bridge_push_sensors.argtypes = [ctypes.c_void_p] + [dptr] * 6
        lib.rt_bridge_read_sensors.argtypes = [ctypes.c_void_p, dptr]
        lib.rt_bridge_read_sensors.restype = ctypes.c_int64
        lib.rt_bridge_set_leg_order.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
        lib.rt_bridge_set_foot_filter.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
        lib.rt_bridge_push_command.argtypes = [ctypes.c_void_p] + [dptr] * 4
        lib.rt_bridge_read_command.argtypes = [ctypes.c_void_p, dptr]
        lib.rt_bridge_read_command.restype = ctypes.c_int64
        lib.rt_rate_create.restype = ctypes.c_void_p
        lib.rt_rate_create.argtypes = [ctypes.c_double]
        lib.rt_rate_wait.argtypes = [ctypes.c_void_p]
        lib.rt_rate_overruns.argtypes = [ctypes.c_void_p]
        lib.rt_rate_overruns.restype = ctypes.c_int64
        lib.rt_rate_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_bridge_timing_test.restype = ctypes.c_double
        lib.rt_bridge_timing_test.argtypes = [ctypes.c_double, ctypes.c_int]
        _lib = lib
        return lib


def _as_dptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class RtBridge:
    """Lock-free sensor / command blackboard with safety clamps."""

    def __init__(self, power_level=5, foot_filter_window=0,
                 sdk_leg_order=False):
        """Args:
          power_level: 1..10, the PowerProtect torque budget in tenths of
            each joint class's ceiling.
          foot_filter_window: 5-sample receive-side foot-force ring filter
            (HardwareA1ROS.cpp:300-312); 0 = raw passthrough (the Gazebo
            adapter does not filter). The divisor is always the full
            window, the reference's quirk (the first pushes read low).
          sdk_leg_order: True for a real Unitree SDK feed: sensor frames
            are pushed, and command frames read back, in wire order (FR,
            FL, RR, RL); the bridge remaps to and from the controller order
            (FL, FR, RL, RR) like the reference's swap_joint_indices /
            swap_foot_indices (HardwareA1ROS.cpp:78-79, 293-298). Sim
            feeders already speak controller order.
        """
        self._lib = _load()
        self._h = self._lib.rt_bridge_create(int(power_level))
        if foot_filter_window:
            self._lib.rt_bridge_set_foot_filter(self._h,
                                                int(foot_filter_window))
        if sdk_leg_order:
            self._lib.rt_bridge_set_leg_order(self._h, 1)

    def close(self):
        if self._h:
            self._lib.rt_bridge_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _handle(self):
        if not self._h:
            raise RuntimeError("the bridge is closed")
        return self._h

    def push_sensors(self, quat, acc, gyro, joint_pos, joint_vel,
                     foot_force):
        args = [np.ascontiguousarray(a, np.float64)
                for a in (quat, acc, gyro, joint_pos, joint_vel, foot_force)]
        self._lib.rt_bridge_push_sensors(self._handle(),
                                         *[_as_dptr(a) for a in args])

    def read_sensors(self):
        """Returns (tick, dict of sensor arrays)."""
        buf = np.zeros(38, np.float64)
        tick = self._lib.rt_bridge_read_sensors(self._handle(),
                                                _as_dptr(buf))
        return tick, {
            "quat": buf[0:4], "acc": buf[4:7], "gyro": buf[7:10],
            "joint_pos": buf[10:22], "joint_vel": buf[22:34],
            "foot_force": buf[34:38],
        }

    def push_command(self, tau, q=None, kp=None, kd=None):
        z = np.zeros(12, np.float64)
        args = [np.ascontiguousarray(a if a is not None else z, np.float64)
                for a in (tau, q, kp, kd)]
        self._lib.rt_bridge_push_command(self._handle(),
                                         *[_as_dptr(a) for a in args])

    def read_command(self):
        buf = np.zeros(48, np.float64)
        tick = self._lib.rt_bridge_read_command(self._handle(),
                                                _as_dptr(buf))
        return tick, {"tau": buf[0:12], "q": buf[12:24],
                      "kp": buf[24:36], "kd": buf[36:48]}


class RateKeeper:
    """Compensated-sleep loop pacing (MainHardware.cpp:85-129)."""

    def __init__(self, period_s):
        self._lib = _load()
        self._h = self._lib.rt_rate_create(float(period_s))

    def wait(self):
        self._lib.rt_rate_wait(self._h)

    @property
    def overruns(self):
        return self._lib.rt_rate_overruns(self._h)

    def close(self):
        if self._h:
            self._lib.rt_rate_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def timing_self_test(period_s=0.002, iters=100):
    """Worst observed period error of the native compensated loop."""
    return _load().rt_bridge_timing_test(float(period_s), int(iters))
