"""PyTorch/CUDA port of the convex-MPC quadruped controller.

Counterpart of ``go1_qp_mpc_controller_tpu`` (the JAX reference, which this
package never imports). Every function takes an explicit leading batch
axis where the JAX package used ``vmap``; state containers are
``NamedTuple``s of tensors. Entry points place their tensors on the CUDA
device unless the caller passes ``device="cpu"``; on CUDA the two
hand-written Hopper kernels (``ops/kkt_schulz.py``, ``ops/observe_ekf.py``)
carry the closed-loop tick.
"""
