"""Train and eval steps and checkpoints (port of ``repro.train``)."""
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.step import (default_optimizer, make_eval_step,
                                    make_serve_decode, make_serve_prefill,
                                    make_train_step)

__all__ = ["make_train_step", "make_serve_prefill", "make_serve_decode",
           "make_eval_step", "default_optimizer", "save_checkpoint",
           "load_checkpoint"]
