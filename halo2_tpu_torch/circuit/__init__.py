from .value import Assigned, Value, to_assigned
from .floor_planner_v1 import V1FloorPlanner
from .layouter import (
    AssignedCell,
    Assignment,
    Cell,
    Circuit,
    Layouter,
    NamespacedLayouter,
    Region,
    SimpleFloorPlanner,
    SingleChipLayouter,
    Table,
)
