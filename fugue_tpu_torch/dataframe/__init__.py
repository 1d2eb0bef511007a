from fugue_tpu_torch.dataframe.dataframe import DataFrame

__all__ = ["DataFrame"]
