from .sampler import CondBranch, denoise
from .schedulers import NoiseSchedule, SamplerPlan, ddim_plan, make_plan
