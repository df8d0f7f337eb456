"""The LM model zoo's dense and MoE families, ported: configs in
``repro_torch.configs``, layers here, ``model.build_model`` as the entry
point (counterpart of ``repro.models``)."""
