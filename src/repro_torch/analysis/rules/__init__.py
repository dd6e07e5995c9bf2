"""Built-in orchestration-contract rules.

Importing this package registers every rule with the framework registry.
"""
from . import rng            # noqa: F401
from . import purity         # noqa: F401
from . import schema         # noqa: F401
from . import jit            # noqa: F401
from . import deprecation    # noqa: F401
from . import registry_parity  # noqa: F401
from . import kernel_hygiene   # noqa: F401
from . import unit_consistency  # noqa: F401
from . import span_parity      # noqa: F401
