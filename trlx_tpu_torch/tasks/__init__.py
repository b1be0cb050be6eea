"""Acceptance tasks of the port: the randomwalks shortest-path task
(``randomwalks.py``) and its PPO and ILQL runs (``ppo_randomwalks.py``,
``ilql_randomwalks.py``), the port's copies of ``examples/randomwalks/``.
Each run's ``main(hparams)`` runs on the GPU unless ``device="cpu"``."""
