from fugue_tpu_torch.extensions.context import ExtensionContext
from fugue_tpu_torch.extensions.convert import (
    cotransformer,
    creator,
    output_cotransformer,
    output_transformer,
    outputter,
    processor,
    register_creator,
    register_output_transformer,
    register_outputter,
    register_processor,
    register_transformer,
    transformer,
)
from fugue_tpu_torch.extensions.interfaces import (
    CoTransformer,
    Creator,
    OutputCoTransformer,
    Outputter,
    OutputTransformer,
    Processor,
    Transformer,
)
