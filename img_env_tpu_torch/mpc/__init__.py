"""Sampling and gradient MPC over the differentiable navigation dynamics."""

from img_env_tpu_torch.mpc.controller import MpcController, MpcState
from img_env_tpu_torch.mpc.cost import CostWeights, WorldCost
from img_env_tpu_torch.mpc.edt import edt2d, edt2d_device
from img_env_tpu_torch.mpc.ilqr import (IlqrConfig, batched_ilqr, ilqr_solve,
                                        smooth_step)
from img_env_tpu_torch.mpc.lqr import (LqtProblem, lqt_backward_assoc,
                                       lqt_backward_seq)
from img_env_tpu_torch.mpc.mppi import (MppiConfig, PlannerState,
                                        batched_mppi, cem_plan, init_planner,
                                        mppi_plan)
from img_env_tpu_torch.mpc.prediction import predict_peds

__all__ = [
    "IlqrConfig",
    "batched_ilqr",
    "ilqr_solve",
    "smooth_step",
    "LqtProblem",
    "lqt_backward_assoc",
    "lqt_backward_seq",
    "MpcController",
    "MpcState",
    "CostWeights",
    "WorldCost",
    "edt2d",
    "edt2d_device",
    "MppiConfig",
    "PlannerState",
    "batched_mppi",
    "cem_plan",
    "init_planner",
    "mppi_plan",
    "predict_peds",
]
