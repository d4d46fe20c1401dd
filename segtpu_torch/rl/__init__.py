from segtpu_torch.rl.controller import MicroControllerSpec, controller_init, sample, evaluate, genotype_from_actions  # noqa: F401
from segtpu_torch.rl.agent import create_agent, train_agent  # noqa: F401
