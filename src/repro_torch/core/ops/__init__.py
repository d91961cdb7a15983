"""IR flavors this package executes.

  * ``cf.*``   control-flow-like higher-order instructions
  * ``rel.*``  relational flavor (Select/Proj/ExProj/Aggr/Join/...)
  * ``vec.*``  physical vector flavor (ScanVec/GroupAggDirect/...)
"""

from . import controlflow, relational, vec  # noqa: F401
