from repro_torch.data.synthetic import (fphab_batches, fphab_sample,
                                        openeds_batches, openeds_sample,
                                        token_batches)

__all__ = ["fphab_batches", "fphab_sample", "openeds_batches",
           "openeds_sample", "token_batches"]
