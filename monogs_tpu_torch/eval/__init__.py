from .ate import eval_ate, evaluate_ate  # noqa: F401
from .rendering import eval_rendering  # noqa: F401
