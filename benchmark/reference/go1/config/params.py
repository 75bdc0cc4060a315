"""Controller constants used by the port.

The port's own copy of the values in the JAX package's ``config/params.py``
(itself a mirror of the reference's A1Params.h), every one of them.
"""

# --- loop cadences (milliseconds) (A1Params.h:10-12) ---------------------
GRF_UPDATE_PERIOD_MS = 0.5      # MPC / GRF thread target period
MAIN_UPDATE_PERIOD_MS = 0.5     # plan + torque + send thread target period
HARDWARE_FEEDBACK_PERIOD_MS = 1.0  # hardware sensor / EKF loop period

# --- joystick command limits (A1Params.h:16-23) --------------------------
JOY_CMD_BODY_HEIGHT_MAX = 0.32  # m
JOY_CMD_BODY_HEIGHT_MIN = 0.1   # m
JOY_CMD_BODY_HEIGHT_VEL = 0.04  # m/s
JOY_CMD_VELX_MAX = 0.6          # m/s
JOY_CMD_VELY_MAX = 0.3          # m/s
JOY_CMD_YAW_MAX = 0.8           # rad
JOY_CMD_PITCH_MAX = 0.4         # rad
JOY_CMD_ROLL_MAX = 0.4          # rad

# --- MPC problem dimensions (A1Params.h:26-28) ---------------------------
PLAN_HORIZON = 10               # MPC lookahead steps
MPC_STATE_DIM = 13              # (rpy, pos, omega, vel, gravity)
MPC_CONSTRAINT_DIM = 20         # 5 friction-pyramid rows per leg

# --- robot dimensions (A1Params.h:31-36) ---------------------------------
NUM_LEG = 4
NUM_DOF_PER_LEG = 3
DIM_GRF = 12
NUM_DOF = 12
LOWER_LEG_LENGTH = 0.21

# --- contact detection force thresholds (N) (A1Params.h:38-39) -----------
FOOT_FORCE_LOW = 30.0
FOOT_FORCE_HIGH = 80.0

# --- swing clearances (m) (A1Params.h:41-42) -----------------------------
FOOT_SWING_CLEARANCE1 = 0.0
FOOT_SWING_CLEARANCE2 = 0.4

# --- Raibert foothold delta clamp (m) (A1Params.h:44-45) -----------------
FOOT_DELTA_X_LIMIT = 0.1
FOOT_DELTA_Y_LIMIT = 0.1

# --- joint position limits (rad) per (hip, thigh, calf), the terminal-state
# check (GazeboA1ROS.h:175-179) -------------------------------------------
JOINT_POS_LIMITS = (
    (-1.047, 1.047),    # hip
    (-0.663, 2.966),    # thigh
    (-2.721, -0.837),   # calf
)

# --- MPC QP constants (ConvexMpc.cpp:8, :223-224) ------------------------
MPC_MU = 0.3                    # friction coefficient
MPC_FZ_MIN = 0.0                # N, per-leg normal force lower bound
MPC_FZ_MAX = 180.0              # N, per-leg normal force upper bound

# --- MPC discretization dt on hardware (s) (A1RobotControl.cpp:458-462) --
HARDWARE_MPC_DT = 0.0025

# --- derived QP sizes -----------------------------------------------------
MPC_NV = NUM_DOF * PLAN_HORIZON             # 120 decision variables
MPC_NC = MPC_CONSTRAINT_DIM * PLAN_HORIZON  # 200 constraint rows
GRAVITY = 9.8                               # dynamics / Raibert / plant
EKF_GRAVITY = 9.81                          # EKF input gravity (A1BasicEKF.cpp:76)

# --- balance-QP constants (A1RobotControl.cpp:28-48, :393-413) ------------
QP_MU = 0.7
QP_F_MIN = 0.0
QP_F_MAX = 180.0
QP_R_WEIGHT = 1e-3
QP_Q_WEIGHTS = (1.0, 1.0, 1.0, 400.0, 400.0, 100.0)
