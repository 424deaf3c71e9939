"""The paper's own experiment: (strongly-)convex logistic regression
trained by asynchronous FL (Section 4 / Supp. E)."""
from repro_torch.configs.base import (DPConfig, FLConfig,
                                      SampleSequenceConfig, StepSizeConfig)

#: the widest data the configuration's source names: MNIST subsets,
#: 28 x 28 = 784 features (D = 785 with the bias)
SOURCE = "[paper §4, Supp. E: LIBSVM binary / MNIST subsets]"
MNIST_FEATURES = 784


def fl_config_fig1b() -> FLConfig:
    """Fig 1b / Example 3: DP, sigma=8, s_i = 16 + ceil(1.322 i), K=25000."""
    return FLConfig(
        n_clients=5,
        sample_seq=SampleSequenceConfig(kind="power", s0=16, p=1.0,
                                        q=0.00013216327772100012,
                                        m=12.106237281566509, N_c=10_000),
        step_size=StepSizeConfig(kind="inv_t", eta0=0.15, beta=0.001,
                                 round_transform=True),
        dp=DPConfig(enabled=True, clip_norm=0.1, sigma=8.0,
                    granularity="example", delta=5.5e-8, epsilon=1.0),
        total_grads=25_000,
    )
