from .model import Model, build_model
from .sharding_ctx import LayoutPlan, current_plan, use_plan

__all__ = ["Model", "build_model", "LayoutPlan", "current_plan", "use_plan"]
