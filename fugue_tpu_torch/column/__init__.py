from fugue_tpu_torch.column.expressions import ColumnExpr, col, lit

__all__ = ["ColumnExpr", "col", "lit"]
