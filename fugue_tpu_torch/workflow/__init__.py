from fugue_tpu_torch.workflow.checkpoint import (
    Checkpoint,
    CheckpointPath,
    StrongCheckpoint,
    WeakCheckpoint,
)
from fugue_tpu_torch.workflow.module import module
from fugue_tpu_torch.workflow.workflow import (
    FugueWorkflow,
    FugueWorkflowResult,
    WorkflowDataFrame,
)
