"""The generator umbrella model (port of the JAX package's
``models/model.py``).

embeddings -> scene-graph conv stack -> box MLP / mask net / appearance
vectors (encoded ground-truth crops, or repr MLP with the feature override)
-> layout -> pix2pixHD generator. ``model.train()`` is the training forward
(summed layouts of the ground truth, crops of the ground-truth image),
``model.eval()`` the test-mode forward (occlusion layout) that serving
runs. Each stage runs in a profiler range of its own
(``profiling.span``): ``model/graph``, ``model/appearance``,
``model/heads``, ``model/layout`` (each layout of the train mode apart)
and ``model/generator``.

Padded-batch contract:
  objs         (N, O)    int class ids (0 also pads; see obj_mask)
  triples      (N, T, 3) int local [s, p, o]
  attributes   (N, O, A) float size + location one-hots
  obj_mask     (N, O)    1.0 for real object slots
  triple_mask  (N, T)    1.0 for real triples

The model computes in the dtype of its parameters: serving stores them in
the compute dtype (``model.to(dtype)``), training keeps them f32 (see
``trainer/train_state.py``). Boxes, masks and images come out in float32,
as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch.config import ModelConfig
from scene_generation_tpu_torch.models.generators import (AppearanceEncoder,
                                                          GlobalGenerator,
                                                          MaskNet)
from scene_generation_tpu_torch.models.graph import (GraphTripleConv,
                                                     GraphTripleConvNet)
from scene_generation_tpu_torch.models.layers import (MLP, linear_init_,
                                                      normal_)
from scene_generation_tpu_torch.ops.crop import crop_bbox_batch
from scene_generation_tpu_torch.ops.images import wire_to_float
from scene_generation_tpu_torch.ops.layout import (composite_layout,
                                                   masks_to_layout,
                                                   masks_to_layout_weights)
from scene_generation_tpu_torch.ops.sampling import exact_f32_matmul
from scene_generation_tpu_torch.profiling import span


class ModelOutput(NamedTuple):
    imgs_pred: torch.Tensor                # (N, H, W, 3)
    boxes_pred: torch.Tensor               # (N, O, 4)
    masks_pred: torch.Tensor               # (N, O, M, M)
    layout: Optional[torch.Tensor]         # GT layout (train; None in test)
    layout_pred: Optional[torch.Tensor]    # (N, H, W, D) predicted layout
    layout_wrong: Optional[torch.Tensor]   # wrong-texture layout (train)
    obj_repr: torch.Tensor                 # (N, O, rep_size)
    cls_vecs: torch.Tensor                 # (N, O, Ccls) layout class part


class SceneModel(nn.Module):
    """The reference ``Model`` on the padded contract."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.obj_embeddings = nn.Embedding(cfg.num_objs, cfg.embedding_dim)
        self.pred_embeddings = nn.Embedding(cfg.num_preds, cfg.embedding_dim)
        if cfg.layout_embed_dim:
            self.class_embed = nn.Embedding(cfg.num_objs,
                                            cfg.layout_embed_dim)
        attributes_dim = cfg.num_attributes if cfg.use_attributes else 0
        if cfg.gconv_num_layers == 0:
            self.gconv_linear = nn.Linear(cfg.embedding_dim + attributes_dim,
                                          cfg.gconv_dim)
        else:
            self.gconv = GraphTripleConv(
                cfg.embedding_dim, attributes_dim=attributes_dim,
                output_dim=cfg.gconv_dim, hidden_dim=cfg.gconv_hidden_dim,
                pooling=cfg.gconv_pooling,
                mlp_normalization=cfg.mlp_normalization)
        if cfg.gconv_num_layers > 1:
            self.gconv_net = GraphTripleConvNet(
                cfg.gconv_dim, num_layers=cfg.gconv_num_layers - 1,
                hidden_dim=cfg.gconv_hidden_dim, pooling=cfg.gconv_pooling,
                mlp_normalization=cfg.mlp_normalization)
        self.box_net = MLP((cfg.box_dim, cfg.gconv_hidden_dim, 4),
                           batch_norm=cfg.mlp_normalization,
                           final_nonlinearity=cfg.box_net_final == "relu")
        self.mask_net = MaskNet(cfg.g_mask_dim, cfg.mask_size)
        self.repr_net = MLP((cfg.g_mask_dim, cfg.rep_hidden_size,
                             cfg.rep_size), batch_norm=cfg.mlp_normalization)
        self.image_encoder = AppearanceEncoder(
            cfg.appearance_arch, cfg.g_mask_dim,
            normalization=cfg.appearance_normalization,
            activation=cfg.activation)
        self.layout_to_image = GlobalGenerator(
            cfg.layout_nc, output_nc=cfg.output_nc, ngf=cfg.ngf,
            n_downsampling=cfg.n_downsample_global,
            n_blocks=cfg.n_blocks_global, torch_deconv=cfg.torch_deconv)

    def init_params(self, gen: torch.Generator) -> None:
        for emb in (self.obj_embeddings, self.pred_embeddings):
            normal_(emb.weight, emb.embedding_dim ** -0.5, gen)
        if self.cfg.layout_embed_dim:
            normal_(self.class_embed.weight, 1.0, gen)
        if self.cfg.gconv_num_layers == 0:
            linear_init_(self.gconv_linear, 1.0, gen)

    def forward(self, objs: torch.Tensor, triples: torch.Tensor,
                attributes: torch.Tensor, obj_mask: torch.Tensor,
                triple_mask: torch.Tensor, mask_noise: torch.Tensor,
                imgs: Optional[torch.Tensor] = None,
                boxes_gt: Optional[torch.Tensor] = None,
                masks_gt: Optional[torch.Tensor] = None,
                use_gt_box: bool = False,
                features: Optional[torch.Tensor] = None,
                features_mask: Optional[torch.Tensor] = None,
                wrong_rep: Optional[torch.Tensor] = None,
                return_layout: bool = False) -> ModelOutput:
        """Train-mode (``model.train()``) or test-mode forward.

        Args beyond the padded contract:
          mask_noise: (mask_noise_dim,), ONE noise vector shared by every
            object in the batch (the reference's quirk).
          imgs: (N, H, W, 3) ground-truth images, uint8 wire format or
            float; with ``features=None`` each object's appearance vector
            encodes its crop of them (``object_size``).
          boxes_gt / use_gt_box: composite with the given boxes instead of
            the predicted ones (training always composites ``boxes_gt``).
          masks_gt: composite with the given masks instead of the predicted
            (training: the ground-truth layout).
          features / features_mask: (N, O, rep_size) appearance vectors and
            which rows they override.
          wrong_rep: (N, O, rep_size) appearance vectors of the
            wrong-texture layout (training; default: the objects' own).
          return_layout: also materialize the (N, H, W, D) layout on the
            factored test-mode path (the other paths always build it).
        """
        cfg = self.cfg
        dtype = self.obj_embeddings.weight.dtype
        n, o = objs.shape
        h, w = cfg.image_size

        with span("model/graph"):
            obj_vecs = self.scene_graph_to_vectors(objs, triples, attributes,
                                                   triple_mask, obj_mask)
        noise = mask_noise.to(dtype).expand(n, o, cfg.mask_noise_dim)
        mask_vecs = torch.cat([obj_vecs, noise], dim=-1)
        flat_w = obj_mask.reshape(n * o)

        with span("model/appearance"):
            if features is None:
                # Encode the ground-truth crops (the crop kernels on the
                # card).
                s = cfg.object_size
                crops = crop_bbox_batch(wire_to_float(imgs).to(dtype),
                                        boxes_gt, s)
                obj_repr = self.encode_crops(
                    crops.reshape(n * o, s, s, 3),
                    flat_w).reshape(n, o, cfg.rep_size)
            else:
                obj_repr = self.repr_net(mask_vecs.reshape(n * o, -1),
                                         flat_w).reshape(n, o, cfg.rep_size)
                if features_mask is None:
                    features_mask = torch.ones((n, o), dtype=dtype,
                                               device=objs.device)
                fm = features_mask[..., None].to(dtype)
                obj_repr = fm * features.to(dtype) + (1 - fm) * obj_repr

        with span("model/heads"):
            if cfg.layout_embed_dim:
                cls_vecs = self.class_embed(objs.long())
            else:
                cls_vecs = F.one_hot(objs.long(), cfg.num_objs).to(dtype)
            layout_vecs = torch.cat([cls_vecs, obj_repr], dim=-1)

            boxes_pred = self.box_net(obj_vecs.reshape(n * o, -1),
                                      flat_w).reshape(n, o, 4).float()
            mask_logits = self.mask_net(
                mask_vecs.reshape(n * o, cfg.g_mask_dim), flat_w)
            masks_pred = torch.sigmoid(mask_logits.float()).reshape(
                n, o, cfg.mask_size, cfg.mask_size)
        if self.training:
            return self._train_layouts(
                boxes_pred, masks_pred, obj_repr, cls_vecs, layout_vecs,
                boxes_gt, masks_gt, obj_mask, wrong_rep)

        with span("model/layout"):
            boxes = (boxes_gt if use_gt_box else boxes_pred).to(dtype)
            masks = (masks_gt if masks_gt is not None
                     else masks_pred).to(dtype)
            if cfg.factored_stem:
                lw = masks_to_layout_weights(layout_vecs, boxes, masks,
                                             obj_mask, h, w, test_mode=True)
                layout_pred = (torch.einsum("nohw,nod->nhwd", lw, layout_vecs)
                               if return_layout else None)
            else:
                layout_pred = composite_layout(layout_vecs, boxes, masks,
                                               obj_mask, h, w)
        with span("model/generator"):
            imgs_pred = (self.layout_to_image(weights=lw, vecs=layout_vecs)
                         if cfg.factored_stem
                         else self.layout_to_image(layout_pred))
        return ModelOutput(
            imgs_pred.float(), boxes_pred, masks_pred, None,
            None if layout_pred is None else layout_pred.float(), None,
            obj_repr.float(), cls_vecs.float())

    def _train_layouts(self, boxes_pred, masks_pred, obj_repr, cls_vecs,
                       layout_vecs, boxes_gt, masks_gt, obj_mask,
                       wrong_rep) -> ModelOutput:
        """The train-mode tail: the image comes from the ground-truth
        layout (summed, not occluded); the predicted boxes and masks train
        only through their own losses. The factored stem contracts the GT
        layout's rank-O weight field (its differentiable ``patches`` form),
        and the GT layout still materializes for D_img."""
        cfg = self.cfg
        h, w = cfg.image_size
        with span("model/layout"):
            if cfg.factored_stem:
                lw_gt = masks_to_layout_weights(layout_vecs, boxes_gt,
                                                masks_gt, obj_mask, h, w)
                with exact_f32_matmul():
                    layout = torch.einsum("nohw,nod->nhwd", lw_gt,
                                          layout_vecs)
            else:
                layout = masks_to_layout(layout_vecs, boxes_gt, masks_gt,
                                         obj_mask, h, w)
        with span("model/generator"):
            imgs_pred = (self.layout_to_image(weights=lw_gt, vecs=layout_vecs)
                         if cfg.factored_stem
                         else self.layout_to_image(layout))
        with span("model/layout"):
            layout_pred = masks_to_layout(layout_vecs, boxes_gt, masks_pred,
                                          obj_mask, h, w)
        if wrong_rep is None:
            wrong_rep = obj_repr
        wrong_vecs = torch.cat([cls_vecs, wrong_rep.to(obj_repr.dtype)], -1)
        with span("model/layout"):
            layout_wrong = masks_to_layout(wrong_vecs, boxes_gt, masks_gt,
                                           obj_mask, h, w)
        return ModelOutput(imgs_pred.float(), boxes_pred, masks_pred,
                           layout.float(), layout_pred.float(),
                           layout_wrong.float(), obj_repr.float(),
                           cls_vecs.float())

    def encode_crops(self, crops_flat: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Appearance path: (B, S, S, 3) crops -> encoder -> repr."""
        enc = self.image_encoder(crops_flat, weights)
        return self.repr_net(enc, weights)

    def scene_graph_to_vectors(self, objs, triples, attributes, triple_mask,
                               obj_mask=None) -> torch.Tensor:
        """Embeddings (+ attributes) through the scene-graph conv stack."""
        cfg = self.cfg
        triples = triples.long()
        edges = torch.stack([triples[..., 0], triples[..., 2]], dim=-1)
        obj_vecs = self.obj_embeddings(objs.long())
        pred_vecs = self.pred_embeddings(triples[..., 1])
        if cfg.use_attributes:
            obj_vecs = torch.cat([obj_vecs, attributes.to(obj_vecs.dtype)],
                                 dim=-1)
        if cfg.gconv_num_layers == 0:
            return self.gconv_linear(obj_vecs)
        obj_vecs, pred_vecs = self.gconv(obj_vecs, pred_vecs, edges,
                                         triple_mask, obj_mask)
        if cfg.gconv_num_layers > 1:
            obj_vecs, pred_vecs = self.gconv_net(obj_vecs, pred_vecs, edges,
                                                 triple_mask, obj_mask)
        return obj_vecs
