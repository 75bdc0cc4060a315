"""Whole-body joint-torque mapping.

Port of the JAX package's ``ctrl/torque.py``
(A1RobotControl::compute_joint_torques, A1RobotControl.cpp:289-319), batch
first: stance legs map GRFs through the Jacobian transpose, swing legs
invert the Jacobian against the scaled kinematic PD force, plus gravity
compensation, a NaN latch and the 10-tick zero-torque warmup.
"""

import torch

from reference.go1.utils import rotations


def compute_joint_torques(state, params):
    """Returns the batched CtrlState with fresh joint_torques (B, 12)."""
    j = state.j_foot                                     # (B, 4, 3, 3)
    batch = j.shape[0]
    # stance: tau = J' (-f_grf)   (A1RobotControl.cpp:303)
    tau_stance = torch.einsum('blji,blj->bli', j, -state.foot_forces_grf)
    # swing: J tau = km * f_kin   (A1RobotControl.cpp:306-307)
    tau_swing = rotations.solve_3x3(j, params.km_foot * state.foot_forces_kin)
    tau = torch.where(state.contacts[..., None], tau_stance, tau_swing)
    tau = tau.reshape(batch, 12) + params.torques_gravity

    # NaN latch: keep the previous value (A1RobotControl.cpp:314-317)
    tau = torch.where(torch.isnan(tau), state.joint_torques, tau)

    # first 10 ticks: zero-torque warmup (A1RobotControl.cpp:292-295)
    counter = state.mpc_init_counter + 1
    tau = torch.where((counter < 10)[:, None], torch.zeros_like(tau), tau)
    return state._replace(joint_torques=tau, mpc_init_counter=counter)
