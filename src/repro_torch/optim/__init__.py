"""AdamW and int8 error-feedback compression over the port's parameter
trees."""
from repro_torch.optim.adamw import (OptConfig, adamw_update,  # noqa: F401
                                     global_norm, init_opt_state, lr_at)
from repro_torch.optim.compress import (compress_with_feedback,  # noqa: F401
                                        dequantize_int8,
                                        init_compression_state,
                                        quantize_int8)
