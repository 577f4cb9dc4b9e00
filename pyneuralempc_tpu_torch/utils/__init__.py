from .timing import time_fn
from .checkpoint import save_pytree, load_pytree
from .check import check_model, check_problem
from .compile_cache import enable_compilation_cache
