"""Core of the port: tree helpers, top-k operators, compressors, the
selection rule and the SASG exchange. Import the submodules directly
(``repro_torch.core.sasg``): the exchange depends on ``repro_torch.comm``,
which depends on the compressors here."""
