from fugue_tpu_torch.column.expressions import ColumnExpr, col, function, lit, null
from fugue_tpu_torch.column.sql import SelectColumns

__all__ = ["ColumnExpr", "SelectColumns", "col", "function", "lit", "null"]
