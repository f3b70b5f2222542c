from .value import Assigned, Value, to_assigned
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
