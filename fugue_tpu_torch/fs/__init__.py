from fugue_tpu_torch.fs.local import LocalFileSystem, check_uri, split_uri, unported_scheme

__all__ = ["LocalFileSystem", "check_uri", "split_uri", "unported_scheme"]
