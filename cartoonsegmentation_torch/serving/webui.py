"""Browser UI of the port's interactive server: its own copy of
``cartoonsegmentation_tpu/serving/webui.py``'s page, a stand-in for the
reference's gradio Web_UI (Web_UI/Launcher.py + Component/*) and
naive_interface.html with no extra dependency: one embedded HTML/JS
page served by the stdlib HTTP server (serving/interface.py), every
route its script fetches answered there.

Tabs:
- Ken Burns: upload → autozoom preview, live scrubber over /get_live
  with a "path" toggle that scrubs the camera crop-path overlay
  (/path_overlay), editable from/to crop boxes (/update_from,
  /update_to), per-stage stepping (the reference's stepping tab,
  Web_UI/Component/Component_AIS.py:493-787: /stages, /stage,
  /step_inpaint, /autozoom_preview), result download (/get_result).
- Segmentation: upload → /segment returns detected instances (JSON)
  and a mask-overlay JPEG rendered server-side.
- Style: per-instance repaint through a running sd-webui server
  (/style_prepare, then /style_apply with the edited masks and
  prompts; Web_UI/Component/Component_Style_Editing.py:1345-2219).
"""
from __future__ import annotations

PAGE_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>CartoonSegmentation (PyTorch/CUDA)</title>
<style>
 body{font-family:sans-serif;margin:1.2em;background:#14161a;color:#e8e8e8}
 h1{font-size:1.2em} .tabs button{margin-right:.4em;padding:.4em 1em;
 background:#2a2e36;color:#e8e8e8;border:1px solid #444;cursor:pointer}
 .tabs button.on{background:#4a6fa5} .pane{display:none;margin-top:1em}
 .pane.on{display:block} img{max-width:100%;border:1px solid #333}
 input[type=number]{width:5em;background:#21242a;color:#eee;border:1px
 solid #444} input[type=text]{background:#21242a;color:#eee;border:1px
 solid #444} label{margin-right:.7em} .row{margin:.6em 0}
 #status{color:#9ad;min-height:1.2em} pre{background:#1c1f24;
 padding:.6em;overflow:auto;max-height:14em}
 a{color:#8fc1ff}
 .stagebtn{margin:0 .2em;padding:.25em .7em;background:#2a2e36;
 color:#ddd;border:1px solid #444;cursor:pointer}
 .stagebtn.on{background:#4a6fa5}
 .insrow{border:1px solid #333;padding:.5em;margin:.5em 0;
 display:flex;gap:1em;align-items:flex-start}
 .insrow canvas{border:1px solid #555;cursor:crosshair}
 .insrow .meta{flex:1}
 .brush{margin-top:.3em}
</style></head><body>
<h1>CartoonSegmentation&nbsp;(PyTorch/CUDA)</h1>
<div class="tabs">
 <button id="tb_kb" class="on" onclick="tab('kb')">Ken Burns</button>
 <button id="tb_seg" onclick="tab('seg')">Segmentation</button>
 <button id="tb_sty" onclick="tab('sty')">Style</button>
 <button id="tb_nfo" onclick="tab('nfo');nfoLoad()">Info</button>
</div>
<div id="status"></div>

<div id="pane_kb" class="pane on">
 <div class="row"><input type="file" id="kb_file" accept="image/*">
  <button onclick="kbLoad()">Process</button>
  <label>depth <select id="cfg_depth">
   <option>leres</option><option>leres_boost</option>
   <option>zoe</option><option>zoe_nk</option>
   <option>default</option><option>marigold</option></select></label>
  <label>inpaint <select id="cfg_inpaint">
   <option>default</option><option>patchmatch</option>
   <option>ldm</option><option>ldm_native</option></select></label>
  <label>detector <select id="cfg_det">
   <option>animeinsseg</option><option>sam</option>
   <option>maskrcnn</option><option>none</option></select></label>
  <label>DoF <input type="checkbox" id="cfg_dof" checked></label>
  <label title="content-aware camera-shift search; off = plain
centered zoom (reference Auto Zoom checkbox)">auto&nbsp;zoom
   <input type="checkbox" id="cfg_az" checked></label>
  <label title="keep per-stage preview frames for the stepping tab
(reference Setting tab's Verbose)">verbose
   <input type="checkbox" id="cfg_verbose" checked></label>
  <label>frames <input type="number" id="cfg_frames" value="75"
   min="2" max="300" style="width:4em"></label>
  <label>depth&nbsp;factor <input type="number" id="cfg_dfac"
   value="1" min="1" max="8" style="width:3em"></label>
  <button onclick="cfgApply()">apply config</button></div>
 <div class="row">
  t=<input type="range" id="kb_t" min="0" max="1" step="0.02" value="0"
     oninput="kbLive()">
  <label>path <input type="checkbox" id="kb_path"
     onchange="kbLive()" title="show the camera crop path overlay
instead of the rendered frame while scrubbing"></label>
  <label>inpaint export <input type="checkbox" id="kb_inp" checked
     onchange="kbDlHref()" title="run the disocclusion inpaint
passes on export (reference IsInpainting checkbox)"></label>
  <a id="kb_dl" style="display:none" href="/get_result"
     download="kenburns.mp4">download video</a></div>
 <div class="row" id="kb_boxes" style="display:none">
  <b>from</b>
  <label>cx <input type="number" id="f_cx"></label>
  <label>cy <input type="number" id="f_cy"></label>
  <label>w <input type="number" id="f_w" onchange="ratioSync('f','w')">
  </label>
  <label>h <input type="number" id="f_h" onchange="ratioSync('f','h')">
  </label>
  <b>to</b>
  <label>cx <input type="number" id="t_cx"></label>
  <label>cy <input type="number" id="t_cy"></label>
  <label>w <input type="number" id="t_w" onchange="ratioSync('t','w')">
  </label>
  <label>h <input type="number" id="t_h" onchange="ratioSync('t','h')">
  </label>
  <label>lock ratio <input type="checkbox" id="kb_lock" checked
   title="changing a crop width/height adjusts the other to keep the
image aspect ratio (reference Adjust_Ratio)"></label>
  <button onclick="kbUpdate()">apply</button>
  <button onclick="azPreview()">autozoom preview</button></div>
 <div class="row" id="kb_steps" style="display:none">
  <b>stepping:</b>
  <button class="stagebtn" onclick="stepPrev()">&#9664; prev</button>
  <button class="stagebtn" onclick="stepNext()">next &#9654;</button>
  <span id="kb_stagebtns"></span>
  <button class="stagebtn" onclick="stepInpaint()">run inpaint
   step</button>
  <button class="stagebtn" onclick="kbViews()">camera views</button>
  <label>n <input type="number" id="kb_nviews" value="6" min="2"
   max="16" style="width:3em"></label></div>
 <div class="row" id="kb_gallery" style="display:none;white-space:
  nowrap;overflow-x:auto"></div>
 <div class="row"><img id="kb_img"
  title="in path mode: click to place the FROM camera center,
shift+click the TO center (reference stepping-tab image selection)"
  onclick="kbPlace(event)"></div>
</div>

<div id="pane_seg" class="pane">
 <div class="row"><input type="file" id="seg_file" accept="image/*">
  <button onclick="segRun()">Detect</button>
  <label>bbox <input type="checkbox" id="seg_bbox" checked></label>
  <label>mask <input type="checkbox" id="seg_mask" checked></label>
  <label>contour <input type="checkbox" id="seg_contour"
   title="draw mask outlines (the reference's Instance Contour
checkbox is a no-op upstream; here it draws)"></label>
  <label>tags <input type="checkbox" id="seg_tags"></label>
  <label>alpha <input type="range" id="seg_alpha" min="0" max="1"
   step="0.05" value="0.75" style="width:6em"></label></div>
 <div class="row"><img id="seg_img"></div>
 <pre id="seg_json"></pre>
</div>

<div id="pane_nfo" class="pane">
 <!-- reference Create_Information_Tab (Component_AIS.py:2720-2726) +
      the setting tab's runtime view: live server health/config -->
 <pre id="nfo_json">loading...</pre>
</div>

<div id="pane_sty" class="pane">
 <div class="row"><input type="file" id="sty_file" accept="image/*">
  <button onclick="styPrepare()">Prepare (detect + tag)</button>
  <button onclick="styRun()">Repaint (one-shot)</button></div>
 <div class="row">
  <label>style prompt <input id="sty_prompt" size="32"
    value="masterpiece, best quality"></label>
  <label>negative <input id="sty_nprompt" size="24"></label></div>
 <div class="row">
  <label>sd-webui url <input id="sty_url" size="40"
    value="http://127.0.0.1:7860/sdapi/v1/img2img"
    onchange="styOptions()"></label>
  <button onclick="styOptions()" title="re-enumerate the server's
models and samplers (reference Utility_Model / Utility_Sampler
dropdown sources)">refresh</button>
  <label>model <select id="sty_model" onchange="styModel()">
    <option value="">(server default)</option></select></label>
  <label>sampler <select id="sty_sampler"></select></label>
 </div>
 <div class="row">
  <label>denoise <input type="number" id="sty_den" step="0.05"
    min="0" max="1" value="0.75"></label>
  <label>steps <input type="number" id="sty_steps" value="24"></label>
  <label title="sd-webui n_iter: extra variant rounds of the final
inpaint (reference Batch Count slider)">batch count
   <input type="number" id="sty_bcount" value="1" min="1" max="16"
    style="width:3em"></label>
  <label title="sd-webui batch_size: images per round (reference
Batch Size slider, max 8)">batch size
   <input type="number" id="sty_bsize" value="1" min="1" max="8"
    style="width:3em"></label>
 </div>
 <div id="sty_rows" style="display:none">
  <div class="row"><label>background prompt
   <input id="sty_bgprompt" size="60"></label></div>
  <div id="sty_instances"></div>
  <div class="row">
   <label>brush <input type="range" id="sty_brush" min="4" max="60"
    value="18" class="brush"></label>
   <label>erase <input type="checkbox" id="sty_erase"></label>
   <button onclick="styApply()">Repaint edited</button></div>
 </div>
 <div class="row">
  <label title="server-side directory of images to style-process in
one go (reference run_style.py directory input, surfaced in the UI)">
   batch dir <input id="sty_bdir" size="30"></label>
  <label>whole-image <input type="checkbox" id="sty_bwhole"></label>
  <button onclick="styBatch()">Run batch</button>
  <span id="sty_bstat"></span></div>
 <div class="row"><img id="sty_img"></div>
 <div class="row" id="sty_gallery" style="display:none;white-space:
  nowrap;overflow-x:auto"></div>
</div>

<script>
function tab(k){for(const p of ['kb','seg','sty','nfo']){
  document.getElementById('pane_'+p).classList.toggle('on', p===k);
  document.getElementById('tb_'+p).classList.toggle('on', p===k);}}
function st(m){document.getElementById('status').textContent=m}

// ---------------- Ken Burns tab -------------------------------------
let stages=[], stageIdx=-1, imgAspect=0;
function ratioSync(p,changed){
  // the reference's aspect-locked crop sliders (Component_AIS.py:
  // 1511-1547 Adjust_Ratio): changing width sets height =
  // round(width/ratio) and vice versa, integer-rounded
  // (Approximate_To_Integer); the server centralise-clamps on apply
  if(!document.getElementById('kb_lock').checked||!imgAspect)return;
  const w=document.getElementById(p+'_w'),
        h=document.getElementById(p+'_h');
  if(changed==='w')h.value=Math.round((+w.value)/imgAspect);
  else w.value=Math.round((+h.value)*imgAspect);}
async function kbLoad(){
  const f=document.getElementById('kb_file').files[0];
  if(!f){st('choose an image first');return}
  st('processing (first run compiles kernels)...');
  const r=await fetch('/load_image',{method:'POST',body:f});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  st('loaded '+j.width+'x'+j.height);
  imgAspect=j.height?j.width/j.height:0;
  if(j.objFrom){
    document.getElementById('kb_boxes').style.display='block';
    const ids=[['f',j.objFrom],['t',j.objTo]];
    for(const [p,bx] of ids){
      document.getElementById(p+'_cx').value=bx.center_u;
      document.getElementById(p+'_cy').value=bx.center_v;
      document.getElementById(p+'_w').value=bx.crop_w;
      document.getElementById(p+'_h').value=bx.crop_h;}}
  document.getElementById('kb_dl').style.display='inline';
  setStages(j.stages||[]);
  kbLive();}
function setStages(names){
  stages=names; stageIdx=-1;
  const box=document.getElementById('kb_stagebtns');
  box.innerHTML='';
  for(let i=0;i<names.length;i++){
    const b=document.createElement('button');
    b.className='stagebtn'; b.textContent=names[i];
    b.id='stg_'+i; b.onclick=()=>showStage(i);
    box.appendChild(b);}
  document.getElementById('kb_steps').style.display=
    names.length?'block':'none';}
function showStage(i){
  stageIdx=i;
  for(let k=0;k<stages.length;k++)
    document.getElementById('stg_'+k).classList.toggle('on',k===i);
  st('stage: '+stages[i]);
  document.getElementById('kb_img').src=
    '/stage?name='+encodeURIComponent(stages[i])+'&_='+Date.now();}
function stepNext(){if(stages.length)
  showStage(Math.min(stageIdx+1,stages.length-1))}
function stepPrev(){if(stages.length)
  showStage(Math.max(stageIdx-1,0))}
async function stepInpaint(){
  st('running inpaint passes...');
  const r=await fetch('/step_inpaint',{method:'POST',body:'{}'});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  st('inpaint passes done');
  setStages(j.stages||[]);
  const k=stages.findIndex(s=>s.startsWith('inpainted'));
  if(k>=0)showStage(k);}
function azPreview(){
  st('autozoom crop preview');
  document.getElementById('kb_img').src=
    '/autozoom_preview?_='+Date.now();}
function kbLive(){
  const t=document.getElementById('kb_t').value;
  // path mode: the camera crop-path overlay (from/to boxes +
  // trajectory + interpolated rectangle at t) instead of the frame
  const ep=document.getElementById('kb_path').checked
    ?'/path_overlay?fltTime=':'/get_live?fltTime=';
  document.getElementById('kb_img').src=ep+t+'&_='+Date.now();}
async function kbViews(){
  // the stepping tab's "Generate Camera View" batched output box:
  // n frames stepped along the camera path, shown as a filmstrip
  const n=+document.getElementById('kb_nviews').value||6;
  st('rendering '+n+' camera views...');
  const r=await fetch('/frames_gallery?n='+n);
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  const g=document.getElementById('kb_gallery');
  g.innerHTML=''; g.style.display='block';
  for(let i=0;i<j.frames.length;i++){
    const im=document.createElement('img');
    im.src='data:image/jpeg;base64,'+j.frames[i];
    im.style.maxWidth=(96/j.frames.length)+'%';
    im.title='t='+(i/(j.frames.length-1)).toFixed(2);
    g.appendChild(im);}
  st(j.count+' camera views');}
function kbDlHref(){
  document.getElementById('kb_dl').href='/get_result?inpaint='+
    (+document.getElementById('kb_inp').checked);}
async function cfgApply(){
  const body={depth_est:document.getElementById('cfg_depth').value,
    inpaint_type:document.getElementById('cfg_inpaint').value,
    detector:document.getElementById('cfg_det').value,
    depth_field:document.getElementById('cfg_dof').checked,
    auto_zoom:document.getElementById('cfg_az').checked,
    stage_previews:document.getElementById('cfg_verbose').checked,
    num_frame:+document.getElementById('cfg_frames').value||75,
    depth_factor:+document.getElementById('cfg_dfac').value||1};
  const r=await fetch('/config',{method:'POST',
    body:JSON.stringify(body)});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  st('config applied ('+j.changed.join(', ')+') — reload the image');}
async function kbPlace(e){
  // click-to-place camera centers while scrubbing the path overlay —
  // the reference's DoOnImageBox_Stepping_TabSelecting interaction
  // (Component_AIS.py:1424-1509): click moves the FROM camera center
  // to the clicked point, shift+click moves the TO center; the
  // server centralise-clamps the box into the image.
  if(!document.getElementById('kb_path').checked)return;
  const im=e.target;
  if(!im.naturalWidth)return;
  const rect=im.getBoundingClientRect();
  const sx=im.naturalWidth/rect.width, sy=im.naturalHeight/rect.height;
  const x=(e.clientX-rect.left)*sx, y=(e.clientY-rect.top)*sy;
  const p=e.shiftKey?'t':'f';
  document.getElementById(p+'_cx').value=Math.round(x);
  document.getElementById(p+'_cy').value=Math.round(y);
  await kbUpdate();
  st((e.shiftKey?'TO':'FROM')+' camera center -> ('+Math.round(x)+
     ', '+Math.round(y)+')');}
async function nfoLoad(){
  try{const j=await (await fetch('/health')).json();
    document.getElementById('nfo_json').textContent=
      JSON.stringify(j,null,1);}
  catch(e){document.getElementById('nfo_json').textContent=
      'health fetch failed: '+e;}}
async function kbUpdate(){
  for(const [p,ep] of [['f','/update_from'],['t','/update_to']]){
    const box={center_u:+document.getElementById(p+'_cx').value,
      center_v:+document.getElementById(p+'_cy').value,
      crop_w:+document.getElementById(p+'_w').value,
      crop_h:+document.getElementById(p+'_h').value};
    await fetch(ep,{method:'POST',body:JSON.stringify(box)});}
  st('crop boxes updated'); kbLive();}

// ---------------- Segmentation tab ----------------------------------
async function segRun(){
  const f=document.getElementById('seg_file').files[0];
  if(!f){st('choose an image first');return}
  st('detecting...');
  // draw options box (reference Component_AIS.py:1881-1916)
  const qp='?draw_bbox='+(+document.getElementById('seg_bbox').checked)
    +'&draw_mask='+(+document.getElementById('seg_mask').checked)
    +'&draw_contour='+(+document.getElementById('seg_contour').checked)
    +'&draw_tags='+(+document.getElementById('seg_tags').checked)
    +'&mask_alpha='+document.getElementById('seg_alpha').value;
  const r=await fetch('/segment'+qp,{method:'POST',body:f});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  st(j.instances.length+' instance(s)');
  document.getElementById('seg_json').textContent=
    JSON.stringify(j.instances,null,1);
  document.getElementById('seg_img').src=
    'data:image/jpeg;base64,'+j.overlay;}
function b64(file){return new Promise(res=>{const r=new FileReader();
  r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(file);})}
function sdPayload(){
  return {style_prompt:document.getElementById('sty_prompt').value,
    global_nprompt:document.getElementById('sty_nprompt').value,
    url:document.getElementById('sty_url').value,
    denoising_strength:+document.getElementById('sty_den').value,
    steps:+document.getElementById('sty_steps').value,
    sampler_name:document.getElementById('sty_sampler').value
      ||'Euler a',
    batch_count:+document.getElementById('sty_bcount').value||1,
    batch_size:+document.getElementById('sty_bsize').value||1};}
// sd-webui model/sampler enumeration into the dropdowns (reference
// Web_UI/Common/Utility_Model.py:1-79 + Utility_Sampler.py:1-31,
// upgraded from directory scan / hardcoded list to the live API)
async function styOptions(){
  const url=encodeURIComponent(document.getElementById('sty_url').value);
  const j=await (await fetch('/style_options?url='+url)).json();
  const sel=document.getElementById('sty_sampler');
  const keep=sel.value;
  sel.innerHTML='';
  for(const s of j.samplers||[]){
    const o=document.createElement('option');
    o.value=o.textContent=s; sel.appendChild(o);}
  sel.value=(j.samplers||[]).includes(keep)?keep:'Euler a';
  const ms=document.getElementById('sty_model');
  ms.innerHTML='<option value="">(server default)</option>';
  for(const m of j.models||[]){
    const o=document.createElement('option');
    o.value=o.textContent=m; ms.appendChild(o);}
  if(j.current_model&&(j.models||[]).includes(j.current_model))
    ms.value=j.current_model;
  st(j.live?'sd-webui options loaded':'sd-webui offline — '+
     'fallback sampler list');}
async function styModel(){
  const m=document.getElementById('sty_model').value;
  if(!m)return;
  st('switching sd model (may take a while)...');
  const r=await fetch('/style_model',{method:'POST',
    body:JSON.stringify({model:m,
      url:document.getElementById('sty_url').value})});
  const j=await r.json();
  st(j.ok?('sd model: '+m):'model switch failed');}
async function styBatch(){
  const d=document.getElementById('sty_bdir').value;
  if(!d){st('enter a server-side directory path');return}
  st('batch processing '+d+'...');
  const payload=Object.assign({dir:d,
    whole_image:document.getElementById('sty_bwhole').checked},
    sdPayload());
  const r=await fetch('/style_batch',{method:'POST',
    body:JSON.stringify(payload)});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  const ok=j.results.filter(x=>x.saved).length;
  document.getElementById('sty_bstat').textContent=
    ok+'/'+j.count+' images -> '+j.save_dir;
  st('batch done: '+ok+'/'+j.count);}
function styGallery(j){
  // batched variants of the final inpaint (reference Batch Count /
  // Batch Size sliders feeding the gradio output gallery); click a
  // variant to promote it to the main output image
  const g=document.getElementById('sty_gallery');
  g.innerHTML='';
  const vars=j.variants||[];
  g.style.display=vars.length?'block':'none';
  for(const v of vars){
    const im=document.createElement('img');
    im.src='data:image/png;base64,'+v;
    im.style.maxWidth=Math.max(12,96/Math.max(vars.length,1))+'%';
    im.style.cursor='pointer';
    im.title='variant — click to select';
    im.onclick=()=>{document.getElementById('sty_img').src=im.src};
    g.appendChild(im);}}

// ---------------- Style tab: per-instance editing -------------------
// prep = server /style_prepare response; each instance row keeps its
// FULL-RES mask in an offscreen canvas the user paints on (white=
// repaint region), displayed composited over the image.
let prep=null, rows=[];
async function styPrepare(){
  const f=document.getElementById('sty_file').files[0];
  if(!f){st('choose an image first');return}
  st('detecting + tagging...');
  const payload=Object.assign({image:await b64(f)},sdPayload());
  const r=await fetch('/style_prepare',{method:'POST',
    body:JSON.stringify(payload)});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  if(!j.instances.length){st(j.note||'no instances');return}
  prep=j; rows=[];
  document.getElementById('sty_bgprompt').value=j.bg_prompt||'';
  const box=document.getElementById('sty_instances');
  box.innerHTML='';
  const img=new Image();
  img.onload=()=>{
    for(let i=0;i<j.instances.length;i++)
      box.appendChild(makeRow(i,img,j.instances[i]));
    document.getElementById('sty_rows').style.display='block';
    st(j.instances.length+' instance(s) — edit masks/prompts, then '+
       'Repaint edited');};
  img.src='data:image/png;base64,'+j.image;}
function makeRow(i,img,ins){
  const row=document.createElement('div'); row.className='insrow';
  // full-res offscreen mask canvas
  const full=document.createElement('canvas');
  full.width=img.width; full.height=img.height;
  const fctx=full.getContext('2d');
  const mimg=new Image();
  const disp=document.createElement('canvas');
  const scale=Math.min(1, 360/img.width);
  disp.width=Math.round(img.width*scale);
  disp.height=Math.round(img.height*scale);
  const dctx=disp.getContext('2d');
  function redraw(){
    dctx.clearRect(0,0,disp.width,disp.height);
    dctx.drawImage(img,0,0,disp.width,disp.height);
    dctx.globalAlpha=0.5;
    dctx.drawImage(full,0,0,disp.width,disp.height);
    dctx.globalAlpha=1.0;}
  mimg.onload=()=>{
    // tint the mask red for display; full canvas stays white-on-black
    fctx.drawImage(mimg,0,0);
    redraw();};
  mimg.src='data:image/png;base64,'+ins.mask;
  let painting=false;
  function paint(e){
    const rect=disp.getBoundingClientRect();
    const x=(e.clientX-rect.left)/scale, y=(e.clientY-rect.top)/scale;
    const r=+document.getElementById('sty_brush').value;
    const erase=document.getElementById('sty_erase').checked;
    fctx.globalCompositeOperation=erase?'destination-out':'source-over';
    fctx.fillStyle='#fff';
    fctx.beginPath(); fctx.arc(x,y,r,0,6.2832); fctx.fill();
    fctx.globalCompositeOperation='source-over';
    redraw();}
  disp.onmousedown=e=>{painting=true;paint(e)};
  disp.onmousemove=e=>{if(painting)paint(e)};
  disp.onmouseup=()=>painting=false;
  disp.onmouseleave=()=>painting=false;
  const meta=document.createElement('div'); meta.className='meta';
  meta.innerHTML='<label><input type="checkbox" id="ins_on_'+i+
    '" checked> instance '+i+'</label><br>'+
    '<textarea id="ins_p_'+i+'" rows="4" style="width:95%;'+
    'background:#21242a;color:#eee;border:1px solid #444"></textarea>';
  row.appendChild(disp); row.appendChild(meta);
  setTimeout(()=>{document.getElementById('ins_p_'+i).value=
    ins.prompt||'';},0);
  rows.push({full:full,idx:i});
  return row;}
function maskB64(full){
  // export the painted full-res canvas as a grayscale mask png:
  // alpha>0 -> 255 (the server thresholds >127)
  const c=document.createElement('canvas');
  c.width=full.width; c.height=full.height;
  const ctx=c.getContext('2d');
  ctx.fillStyle='#000'; ctx.fillRect(0,0,c.width,c.height);
  ctx.drawImage(full,0,0);
  return c.toDataURL('image/png').split(',')[1];}
async function styApply(){
  if(!prep){st('run Prepare first');return}
  st('repainting with edited masks/prompts...');
  const instances=[];
  for(const r of rows){
    if(!document.getElementById('ins_on_'+r.idx).checked)continue;
    instances.push({mask:maskB64(r.full),
      prompt:document.getElementById('ins_p_'+r.idx).value});}
  const payload=Object.assign({image:prep.image,bg:prep.bg,
    mask_fg:prep.mask_fg,instances:instances,
    bg_prompt:document.getElementById('sty_bgprompt').value},
    sdPayload());
  const r=await fetch('/style_apply',{method:'POST',
    body:JSON.stringify(payload)});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  if(!j.image){st('no output');return}
  st('repainted ('+j.outputs+' output[s])');
  document.getElementById('sty_img').src=
    'data:image/png;base64,'+j.image;
  styGallery(j);}
async function styRun(){
  const f=document.getElementById('sty_file').files[0];
  if(!f){st('choose an image first');return}
  st('repainting (needs a running sd-webui)...');
  const payload=Object.assign({image:await b64(f)},sdPayload());
  const r=await fetch('/style',{method:'POST',
    body:JSON.stringify(payload)});
  const j=await r.json();
  if(j.error){st('error: '+j.error);return}
  if(!j.image){st(j.note||'no output');return}
  st('repainted ('+j.outputs+' output[s])');
  document.getElementById('sty_img').src=
    'data:image/png;base64,'+j.image;
  styGallery(j);}
// initialize the config controls from the SERVER's live config, so
// an "apply config" without touching a control never force-resets a
// non-default knob (e.g. a server started with detector: sam)
(async()=>{try{
  const j=await (await fetch('/health')).json();
  const c=j.config||{};
  for(const [id,k] of [['cfg_depth','depth_est'],
      ['cfg_inpaint','inpaint_type'],['cfg_det','detector']])
    if(c[k]!==undefined)document.getElementById(id).value=c[k];
  if(c.depth_field!==undefined)
    document.getElementById('cfg_dof').checked=c.depth_field;
  if(c.auto_zoom!==undefined)
    document.getElementById('cfg_az').checked=c.auto_zoom;
  if(c.stage_previews!==undefined)
    document.getElementById('cfg_verbose').checked=c.stage_previews;
  if(c.num_frame!==undefined)
    document.getElementById('cfg_frames').value=c.num_frame;
  if(c.depth_factor!==undefined)
    document.getElementById('cfg_dfac').value=c.depth_factor;
}catch(e){}
  try{await styOptions();}catch(e){}})();
</script></body></html>
"""
