"""CVM core: the IR language (types, programs, registry, verifier, passes).

This package's own copy of ``repro.core``, trimmed to the flavors the
torch port executes.  Importing ``repro_torch.core`` loads the ``cf``,
``rel``, ``vec`` and ``la`` flavors into the registry.
"""

from . import types, expr  # noqa: F401
from .program import Builder, Instruction, Program, Register, subprogram  # noqa: F401
from .registry import (  # noqa: F401
    OpSpec, ensure_flavors_loaded, infer_output_types, lookup, op, register_op,
    registered_opcodes, require,
)
from .verify import VerificationError, verify  # noqa: F401

ensure_flavors_loaded()
