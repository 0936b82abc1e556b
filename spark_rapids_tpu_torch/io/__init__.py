from .scan import FileSplit, GpuFileScanExec, plan_splits
from .write import GpuFileWriteExec, write_files

__all__ = ["FileSplit", "GpuFileScanExec", "plan_splits",
           "GpuFileWriteExec", "write_files"]
