"""Command-line scripts: wav -> stft -> solver -> istft -> wav on the card.

Run each with ``python -m audio_source_separation_tpu_torch.examples.<name>``
(``separate``, ``walkthrough``, ``beamform``, ``decompose_nmf``,
``prepare_mixture``); ``--device cpu`` runs on the host.
"""
