"""ClientTrainer — the user-overridable local-training contract.

Port of ``fedml_tpu/core/alg_frame/client_trainer.py``: get and set the
model parameters (a tree of tensors in the JAX package's layout,
``utils/weights.tree_from_module``), ``train`` and ``test``, and the hooks
around local training.  The hooks' work in the JAX package — FHE
decryption and encryption, local differential privacy, data poisoning — is
port item A13: a trainer refuses those options when it is built
(``refuse_privacy_options``), so the hooks here pass the parameters
through.
"""

from __future__ import annotations

import abc
from typing import Any, Optional

#: configuration keys whose planes (core/dp, core/fhe, core/security,
#: core/contribution) are port item A13
_PRIVACY_OPTIONS = ("enable_dp", "enable_fhe", "enable_attack",
                    "enable_defense", "enable_contribution")


def refuse_privacy_options(args: Any) -> None:
    """Raise ``NotImplementedError`` naming A13 when ``args`` switches on
    differential privacy, FHE, attacks, defenses or contribution
    assessment."""
    on = [k for k in _PRIVACY_OPTIONS if getattr(args, k, False)]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)} is not ported yet (port item A13)")


class ClientTrainer(abc.ABC):
    """Abstract local trainer owned by one (logical) client."""

    def __init__(self, model: Any, args: Any) -> None:
        refuse_privacy_options(args)
        self.model = model
        self.params: Any = None
        self.id = 0
        self.args = args
        self.local_train_dataset = None
        self.local_test_dataset = None
        self.local_sample_number = 0
        self.rng_seed = int(getattr(args, "random_seed", 0) or 0)

    def set_id(self, trainer_id: int) -> None:
        self.id = trainer_id

    def update_dataset(self, local_train_dataset, local_test_dataset,
                       local_sample_number) -> None:
        self.local_train_dataset = local_train_dataset
        self.local_test_dataset = local_test_dataset
        self.local_sample_number = local_sample_number

    def get_model_params(self) -> Any:
        return self.params

    def set_model_params(self, model_parameters: Any) -> None:
        self.params = model_parameters

    def on_before_local_training(self, train_data=None, device=None,
                                 args=None) -> None:
        """Hook before local training (FHE decryption in the JAX package,
        A13)."""

    def on_after_local_training(self, train_data=None, device=None,
                                args=None) -> None:
        """Hook after local training (local DP noise and FHE encryption in
        the JAX package, A13)."""

    @abc.abstractmethod
    def train(self, train_data, device=None, args=None) -> Any:
        """Run local epochs; updates ``self.params``; returns metrics."""

    def test(self, test_data, device=None, args=None) -> Optional[dict]:
        return None
