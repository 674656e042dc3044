from .beamform import (  # noqa: F401
    DelaySumBeamformer,
    MaxSNRBeamformer,
    MVDRBeamformer,
    delay_sum_beamform,
    max_snr_beamform,
    ml_beamform,
    mvdr_beamform,
)
from .fdica import GradLaplaceFDICA, NaturalGradLaplaceFDICA  # noqa: F401
from .idlma import GaussIDLMA, torch_dnn  # noqa: F401
from .ilrma import (  # noqa: F401
    TILRMA,
    ConsistentGaussILRMA,
    GaussILRMA,
    GGDILRMA,
    KLILRMA,
    RegularizedILRMA,
    tILRMA,
)
from .ipsdta import TIPSDTA, GaussIPSDTA, tIPSDTA  # noqa: F401
from .iva import (  # noqa: F401
    AuxGaussIVA,
    AuxLaplaceIVA,
    GradLaplaceIVA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    SparseAuxIVA,
)
from .mnmf import FastMultichannelISNMF, MultichannelISNMF, MultichanneltNMF  # noqa: F401
from .nmf import EUCNMF, ISNMF, KLNMF, TNMF, CauchyNMF, ComplexEUCNMF, tNMF  # noqa: F401

# the reference has two classes named ``MultichannelISNMF``: this
# covariance-domain factoriser and the Sawada/Ozerov BSS solver; as in the JAX
# package, the BSS solver keeps the name and the factoriser is
# ``CovarianceISNMF`` (or ``models.nmf.MultichannelISNMF``)
from .nmf import MultichannelISNMF as CovarianceISNMF  # noqa: F401
from .ntf import EUCNTF  # noqa: F401
from .prox import PDSBSSBase, ProxLaplaceIVA, SparseProxIVA  # noqa: F401
from .psdtf import LDPSDTF  # noqa: F401

__all__ = [
    "GradLaplaceIVA",
    "NaturalGradLaplaceIVA",
    "AuxLaplaceIVA",
    "AuxGaussIVA",
    "SparseAuxIVA",
    "OverAuxLaplaceIVA",
    "EUCNMF",
    "KLNMF",
    "ISNMF",
    "TNMF",
    "tNMF",
    "CauchyNMF",
    "ComplexEUCNMF",
    "CovarianceISNMF",
    "EUCNTF",
    "GaussILRMA",
    "TILRMA",
    "tILRMA",
    "ConsistentGaussILRMA",
    "GGDILRMA",
    "KLILRMA",
    "RegularizedILRMA",
    "GradLaplaceFDICA",
    "NaturalGradLaplaceFDICA",
    "DelaySumBeamformer",
    "MVDRBeamformer",
    "MaxSNRBeamformer",
    "delay_sum_beamform",
    "ml_beamform",
    "mvdr_beamform",
    "max_snr_beamform",
    "PDSBSSBase",
    "ProxLaplaceIVA",
    "SparseProxIVA",
    "MultichannelISNMF",
    "MultichanneltNMF",
    "FastMultichannelISNMF",
    "GaussIDLMA",
    "torch_dnn",
    "GaussIPSDTA",
    "TIPSDTA",
    "tIPSDTA",
    "LDPSDTF",
]
