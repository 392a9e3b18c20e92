from mri_inr_tpu_torch.configuration.config import (
    EvalConfig,
    ModelConfig,
    TestConfig,
    TrainConfig,
    load_test_configuration,
    load_train_configuration,
)

__all__ = [
    "EvalConfig",
    "ModelConfig",
    "TestConfig",
    "TrainConfig",
    "load_test_configuration",
    "load_train_configuration",
]
