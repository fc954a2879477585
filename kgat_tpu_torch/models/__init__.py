from kgat_tpu_torch.models.kgat import (KGAT, KGATConfig,  # noqa: F401
                                        init_params, params_from_jax)
