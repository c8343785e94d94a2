"""DMD score-distillation training: self-forcing rollouts, the DMD and
critic losses, and the trainer."""
