"""IR flavors this package executes.

  * ``cf.*``   control-flow-like higher-order instructions
  * ``df.*``   generic dataflow frontend flavor
  * ``rel.*``  relational flavor (Select/Proj/ExProj/Aggr/Join/...)
  * ``vec.*``  physical vector flavor (ScanVec/GroupAggDirect/...)
  * ``la.*``   linear-algebra flavor (CDist2/ArgMinRow/SegSum/KMeansStep/...)
  * ``mesh.*`` SPMD mesh backend flavor (MeshExecute/AllReduce/Exchange/...)
  * ``tz.*``   tensor/step-pipeline flavor used by the LM stack
"""

from . import controlflow, dataflow, linalg, mesh, relational, tensor, vec  # noqa: F401
