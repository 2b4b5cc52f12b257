"""Faults planted under a run's timed path, by name, for the tests that
see `correct` come out false. Each patches the program in this process.

  state_unchanged  a train step returns its parameters, momentum and BN
                   statistics as it was given them
  half_batch       a train step leaves out half of each group's images and
                   takes the mean over the rest (its loss times two)
"""

from __future__ import annotations


def apply(name: str) -> None:
    from fewshot_detection_tpu_torch.train import trainer

    if name == "state_unchanged":
        def step(self, params, mom, batch, seen, lr):
            _, _, _, metrics = self.loss_and_grads(params, batch, seen)
            return params, mom, metrics

        trainer._GroupTrainer.step = step
    elif name == "half_batch":
        def halve(original):
            def episode_loss(self, params, *tensors):
                *arrays, seen = tensors
                b = arrays[0].shape[0] // 2
                if len(arrays) == 5:  # meta: x, metax, mask, target, keep (b * n_cls rows)
                    n_cls = arrays[1].shape[0]
                    arrays = [arrays[0][:b], arrays[1], arrays[2], arrays[3][:b],
                              arrays[4][:b * n_cls]]
                else:  # plain: x, target, keep
                    arrays = [a[:b] for a in arrays]
                loss, bn, metrics = original(self, params, *arrays, seen)
                return loss * 2, bn, metrics
            return episode_loss

        trainer.MetaTrainer._episode_loss = halve(trainer.MetaTrainer._episode_loss)
        trainer.PlainTrainer._episode_loss = halve(trainer.PlainTrainer._episode_loss)
    else:
        raise ValueError(f"no fault {name!r}")
