from nnest_torch.flows.model import FastSlowFlowModel, FlowModel
from nnest_torch.flows.factory import build_flow
from nnest_torch.flows.convert import params_from_jax, params_to_jax

__all__ = ['FlowModel', 'FastSlowFlowModel', 'build_flow', 'params_from_jax',
           'params_to_jax']
