from iron_tpu_torch.utils.logging import MetricsWriter, concatenate_result, ExperimentDir
