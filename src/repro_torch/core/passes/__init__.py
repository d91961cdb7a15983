"""Rewriting passes over CVM programs (the ones the torch lowering path runs).

Passes work in the presence of instructions of any flavor: rules that
don't understand an instruction leave it as is.
"""

from .rewriter import (  # noqa: F401
    FixpointWarning, InstructionRule, Pass, PassManager, ProgramRule,
)
from .dce import DeadCodeElimination  # noqa: F401
from .cse import CommonSubexpressionElimination  # noqa: F401
from .fusion import (  # noqa: F401
    FuseJoinGroupAgg, FuseKMeansStep, FuseSelectAgg, FuseSelectGroupAgg,
)
from .parallelize import Parallelize  # noqa: F401
from .lower_vec import Catalog, LowerRelToVec  # noqa: F401
