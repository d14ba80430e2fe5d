from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.models.resnet import (ResNet, ResNetConfig, resnet18,
                                          resnet26, resnet50)

__all__ = ["BertConfig", "BertModel", "GPTConfig", "GPTModel", "ResNet",
           "ResNetConfig", "resnet18", "resnet26", "resnet50"]
