"""Acceptance tasks of the port: the randomwalks shortest-path task
(``randomwalks.py``) and its PPO and ILQL runs (``ppo_randomwalks.py``,
``ilql_randomwalks.py``), the port's copies of ``examples/randomwalks/``;
the sentiment runs (``grpo_sentiments.py``, ``dpo_sentiments.py``, their
data and scorer in ``sentiment.py``), the TL;DR recipe's reward model
and PPO against it (``summarize_rlhf.py``), and the T5 runs
(``ppo_sentiments_t5.py``, ``ilql_summarize_t5.py``). Each run's ``main``
runs on the GPU unless ``device="cpu"``."""
