"""The paper's own experiment: (strongly-)convex logistic regression
trained by asynchronous FL (Section 4 / Supp. E)."""
from repro_torch.configs.base import (DPConfig, FLConfig, ModelConfig,
                                      SampleSequenceConfig, StepSizeConfig)

#: the widest data the configuration's source names: MNIST subsets,
#: 28 x 28 = 784 features (D = 785 with the bias)
SOURCE = "[paper §4, Supp. E: LIBSVM binary / MNIST subsets]"
MNIST_FEATURES = 784


def config(d_features: int = 64) -> ModelConfig:
    # Represented as a degenerate "dense" model: a single linear layer is
    # handled by repro_torch.models.logreg, keyed on family == "logreg".
    return ModelConfig(
        arch_id="paper-logreg",
        family="logreg",
        n_layers=1,
        d_model=d_features,
        vocab_size=2,
        source=SOURCE,
    )


def fl_config_fig1a() -> FLConfig:
    """Fig 1a: strongly convex, eta0=0.1, linear increasing sample sizes."""
    return FLConfig(
        n_clients=5,
        sample_seq=SampleSequenceConfig(kind="linear", s0=50, a=50.0),
        step_size=StepSizeConfig(kind="inv_t", eta0=0.1, beta=0.001,
                                 round_transform=True),
        total_grads=20_000,
    )


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
