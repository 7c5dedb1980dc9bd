"""Monte Carlo layer (counterpart of ``finite_difference_tpu.models.mc``):
threefry and Sobol draws, GBM, Clewlow–Strickland, the discrete-barrier
MC, Longstaff–Schwartz and the Hull–White one-factor curve simulator. The
paths run on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
from .rng import SobolNormalRng, threefry_normals, norm_icdf
from .gbm import GBMParams, GBMSimulator
from .clewlow_strickland import CSParams, CSForwardCurveSimulator
from .discrete_barrier import MCConfig, price_discrete_barrier_mc
from .hw1f import HW1FCurveSimulator, HW1FParams
from .lsm import price_american_lsm

__all__ = [
    "HW1FCurveSimulator",
    "HW1FParams",
    "SobolNormalRng",
    "threefry_normals",
    "norm_icdf",
    "GBMParams",
    "GBMSimulator",
    "CSParams",
    "CSForwardCurveSimulator",
    "MCConfig",
    "price_discrete_barrier_mc",
    "price_american_lsm",
]
