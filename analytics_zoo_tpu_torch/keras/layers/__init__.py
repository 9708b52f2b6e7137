"""Layer library: the layers ported so far."""

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Lambda
from analytics_zoo_tpu_torch.keras.engine.topology import InputLayer
from analytics_zoo_tpu_torch.keras.layers.attention import (
    BERT,
    MultiHeadAttention,
    TransformerBlock,
    TransformerLayer,
)
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    AtrousConvolution2D,
    AveragePooling1D,
    AveragePooling2D,
    Convolution1D,
    Convolution2D,
    DepthwiseConvolution2D,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    MaxPooling1D,
    MaxPooling2D,
    SeparableConvolution2D,
    UpSampling2D,
    ZeroPadding2D,
)
from analytics_zoo_tpu_torch.keras.layers.core import (
    Activation,
    Dense,
    Dropout,
    Flatten,
    Merge,
    Reshape,
    get_activation,
    merge,
)
from analytics_zoo_tpu_torch.keras.layers.crf import (
    CRF,
    crf_decode,
    crf_log_likelihood,
    crf_nll,
    viterbi_decode,
)
from analytics_zoo_tpu_torch.keras.layers.embeddings import (
    Embedding,
    WordEmbedding,
)
from analytics_zoo_tpu_torch.keras.layers.normalization import (
    BatchNormalization,
    LayerNorm,
)
from analytics_zoo_tpu_torch.keras.layers.recurrent import (
    GRU,
    LSTM,
    Bidirectional,
    SimpleRNN,
    TimeDistributed,
)
