"""IR flavors this package executes.

  * ``cf.*``   control-flow-like higher-order instructions
  * ``rel.*``  relational flavor (Select/Proj/ExProj/Aggr/Join/...)
  * ``vec.*``  physical vector flavor (ScanVec/GroupAggDirect/...)
  * ``la.*``   linear-algebra flavor (CDist2/ArgMinRow/SegSum/KMeansStep/...)
"""

from . import controlflow, linalg, relational, vec  # noqa: F401
